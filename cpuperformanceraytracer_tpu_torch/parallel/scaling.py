"""Scaling harness: ms/frame of a world of 1 rank against worlds of N.

Counterpart of ``cpuperformanceraytracer_tpu.parallel.scaling``, with
its protocol: warmup frames, then the mean wall-clock ms/frame over one
timed span (the reference's offline benchmark protocol). Each world of
n ranks is started anew (``parallel.mesh.spawn_world``, spawn; the
worker below lives in the package, so a child imports nothing else);
a world of 1 renders unsharded, a world of n on a (n / spp_shards,
spp_shards) mesh. A rank renders and accumulates its own rows, as the
sharded ``OfflineRenderer`` (JAX's sharded accumulator stays sharded on
its devices too), and the world's time is its slowest rank's.

Ranks that share one card share its time: their "efficiency" then
measures contention and the host staging of gloo, not scaling.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

from cpuperformanceraytracer_tpu_torch.parallel.mesh import (
    make_mesh,
    spawn_world,
    world,
)
from cpuperformanceraytracer_tpu_torch.render.integrator import to_device


@dataclasses.dataclass
class ScalePoint:
    devices: int        # ranks in the world
    ms_per_frame: float
    mrays_per_s: float
    efficiency: float   # vs linear scaling from the first point


def _time_frames(renderer, frames: int) -> float:
    """Warmup frames (each synchronised), then the mean ms/frame over one
    span of ``frames`` frames closed by a synchronisation."""
    for _ in range(max(1, renderer.cfg.warmup_frames)):
        renderer.step()
        renderer.sync()
    t0 = time.perf_counter()
    for _ in range(frames):
        renderer.step()
    renderer.sync()
    return (time.perf_counter() - t0) / frames * 1e3


def _scaling_rank(scene, camera, texture, cfg, frames: int,
                  spp_shards: int) -> float:
    """One rank of a timed world: its ms/frame."""
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer

    n = world()[1]
    mesh = None if n == 1 else make_mesh((n // spp_shards, spp_shards))
    r = OfflineRenderer(cfg, texture=texture, scene=scene, camera=camera,
                        silent=True, mesh=mesh)
    return _time_frames(r, frames)


def measure_scaling(scene, camera, texture, cfg,
                    device_counts: Optional[List[int]] = None,
                    frames: int = 5, spp_shards: int = 1,
                    backend: str = "gloo",
                    timeout: float = 600.0) -> List[ScalePoint]:
    """Time the frame step in a world of each size in ``device_counts``
    (default: 1, 2 and the number of cards), over ``backend``."""
    if device_counts is None:
        device_counts = sorted({1, 2, max(1, torch.cuda.device_count())})
    args = (*to_device((scene, camera), "cpu"),
            None if texture is None else to_device(texture, "cpu"), cfg,
            frames, spp_shards)
    rays = cfg.width * cfg.height * cfg.spp
    points: List[ScalePoint] = []
    base_ms = None
    for n in device_counts:
        ms = max(spawn_world(_scaling_rank, n, args, backend=backend,
                             timeout=timeout))
        if base_ms is None:
            base_ms = ms
        points.append(ScalePoint(
            devices=n, ms_per_frame=ms, mrays_per_s=rays / (ms / 1e3) / 1e6,
            efficiency=(base_ms / ms) / n))
    return points
