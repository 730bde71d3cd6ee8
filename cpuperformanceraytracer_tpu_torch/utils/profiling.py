"""Profiler integration and throughput accounting.

Counterpart of ``cpuperformanceraytracer_tpu.utils.profiling``:
``trace(log_dir)`` records the enclosed block with ``torch.profiler``
(CPU activity, and CUDA activity when a GPU is present) in place of
``jax.profiler.trace``, and writes a Chrome trace (``trace.json``, open
it in chrome://tracing or Perfetto) into ``log_dir``;
``throughput_report`` is the JAX package's rays/s accounting from the
workload shape, with its arithmetic.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "build/cprt_trace"):
    """Profile the enclosed block; yields ``log_dir``. On exit the Chrome
    trace is ``<log_dir>/trace.json``, in which each CUDA kernel the
    block launched appears by its symbol."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclasses.dataclass
class ThroughputReport:
    ms_per_frame: float
    primary_mrays_per_s: float
    max_segment_mrays_per_s: float
    accum_bytes_per_frame: int

    def __str__(self) -> str:
        return (
            f"{self.ms_per_frame:.3f} ms/frame | "
            f"{self.primary_mrays_per_s:.1f} Mray/s primary | "
            f"<= {self.max_segment_mrays_per_s:.1f} Mray/s segments | "
            f"{self.accum_bytes_per_frame / 1e6:.1f} MB accum traffic"
        )


def throughput_report(cfg, ms_per_frame: float) -> ThroughputReport:
    """Rays/s accounting from the workload shape: W*H*spp primary rays a
    frame, at most bounces+1 segments each (a miss or roulette ends a
    path sooner), the f32 accumulator read and written once a frame."""
    primary = cfg.width * cfg.height * cfg.spp
    segments = primary * (cfg.bounces + 1)
    s = ms_per_frame / 1e3
    return ThroughputReport(
        ms_per_frame=ms_per_frame,
        primary_mrays_per_s=primary / s / 1e6,
        max_segment_mrays_per_s=segments / s / 1e6,
        accum_bytes_per_frame=cfg.width * cfg.height * 3 * 4 * 2,
    )
