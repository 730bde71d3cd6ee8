"""The traced window: ``torch.profiler`` over a fixed number of calls,
read back from its Chrome trace.

From the trace: the device operations (kernels, memsets, copies) with
their names, start and length; the window, from the start of the first
to the end of the last (on the device's clock alone, so that no offset
between the host's and the device's timestamps enters it, and the
stream's start from empty after a synchronise is not counted); the
seconds in which any operation ran (their union); the device time by name; and the idle gaps between them, each
named by what the host was doing in its middle (the innermost host
event that covers that time). The profiler drops the records of some
CUDA-graph replays now and then, so a kernel's time is taken per
recorded launch and the launches seen are printed beside those made.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    calls: int
    window_s: float                 # the first device op's start to the last's end
    ops: list                       # (name, start_us, dur_us) on the device
    host: list                      # (name, start_us, dur_us) on the host

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        total, end = 0.0, float("-inf")
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if s + d <= end:
                continue
            total += s + d - max(s, end)
            end = s + d
        return total / 1e6

    def by_name(self) -> dict:
        """{name: (launches, total seconds)} of the device operations."""
        out = {}
        for name, _, d in self.ops:
            n, t = out.get(name, (0, 0.0))
            out[name] = (n + 1, t + d / 1e6)
        return out

    def matching(self, patterns) -> dict:
        """{name: (launches, seconds)} of the operations whose name holds
        any of ``patterns``."""
        return {k: v for k, v in self.by_name().items()
                if any(p in k for p in patterns)}

    def gaps(self, top: int = 10) -> list:
        """[(what the host was doing, seconds)] of the ``top`` longest idle
        gaps between device operations, longest first."""
        found, end = [], None
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                found.append(((end + s) / 2, (s - end) / 1e6))
            end = s + d if end is None else max(end, s + d)
        found = sorted(found, key=lambda g: -g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        return [(_host_at(host, t), sec) for t, sec in found]


def _host_at(host, t: float) -> str:
    """The innermost (latest-starting) host event covering time ``t``."""
    best = None
    for name, s, d in host:
        if s > t:
            break
        if s + d >= t:
            best = name
    return best or "host idle"


def read_chrome_trace(path: Path):
    """(device ops, host events) of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        rec = (e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(rec)
        elif cat in HOST_CATS:
            host.append(rec)
    return ops, host


def span_s(ops) -> float:
    """Seconds from the start of the first device operation to the end of
    the last, or 0 where there is none."""
    if not ops:
        return 0.0
    return (max(s + d for _, s, d in ops) - min(s for _, s, _ in ops)) / 1e6


def traced(call, n: int, path: Path) -> Trace:
    """Profile ``n`` calls enqueued back to back and the synchronise that
    ends them; the Chrome trace goes to ``path``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("bench.call"):
                call()
        with record_function("bench.sync"):
            torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    ops, host = read_chrome_trace(path)
    return Trace(n, span_s(ops), ops, host)
