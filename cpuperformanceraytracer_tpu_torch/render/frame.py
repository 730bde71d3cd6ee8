"""The progressive frame step: kernel A -> kernel B, and image output.

Counterpart of ``cpuperformanceraytracer_tpu.render.frame`` on the main
path (``make_frame_fn`` -> ``render_accumulate_pallas``). The
accumulator is one planar (3, H, W) f32 tensor, updated IN PLACE by
each step: the counterpart of the JAX step's donated buffer.

Image convention: (H, W), row 0 = top; the fragCoord y of a row is
H-1-row.
"""

from __future__ import annotations

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.core.color import postprocess_color, to_u8
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
    env_accumulate,
    env_accumulate_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    pack_tables,
    render_planes,
    render_planes_reference,
)


def frame_blend(frame: int) -> float:
    """1 / (f32(frame) + 1) in f32: frame 0 stores its color exactly."""
    return float(np.float32(1.0) / (np.float32(frame) + np.float32(1.0)))


def accumulate_frame(accum, color, frame: int):
    """accum += (color - accum) / (frame + 1), in place."""
    blend = frame_blend(frame)
    for c in range(3):
        accum[c] += (color[c] - accum[c]) * blend
    return accum


def zero_accum(cfg, device="cpu") -> torch.Tensor:
    return torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32,
                       device=device)


def postprocess_image(accum, exposure: float = 1.0) -> torch.Tensor:
    """(3, H, W) f32 -> (H, W, 3) u8: exposure, ACES, sRGB, round."""
    return to_u8(postprocess_color(Vec3(accum[0], accum[1], accum[2]),
                                   exposure))


def make_frame_fn(cfg, scene, camera, device):
    """Build ``step(texture, frame, accum) -> accum``: one progressive
    frame of ``cfg.spp`` samples, accumulated into ``accum`` in place.

    ``cfg.backend`` picks the kernels ("cuda") or their plain-torch
    versions ("torch"); the scene is packed into the kernel tables on
    ``device`` once, here. spp > 1 with an env map renders one sample
    per kernel-A launch on addressable counter streams, sums the
    resolved colors with kernel B and divides once, as the JAX step;
    the sequential wang stream cannot split that way and raises."""
    cfg = cfg.validate()
    if cfg.spp > 1 and cfg.env_mode != "none" and cfg.rng != "counter":
        raise NotImplementedError(
            "spp > 1 with an env map needs rng='counter' (per-sample "
            "addressable streams); the wang stream is sequential across "
            "the sample loop")
    tables = pack_tables(scene, camera, cfg, device)
    if cfg.backend == "cuda":
        render, resolve = render_planes, env_accumulate
    else:
        render, resolve = render_planes_reference, env_accumulate_reference

    def step(texture, frame: int, accum: torch.Tensor) -> torch.Tensor:
        if cfg.env_mode == "none" or cfg.spp == 1:
            planes = render(tables, cfg, frame)
            return resolve(planes, texture, cfg, accum, frame_blend(frame))
        one = cfg.replace(spp=1)
        total = torch.zeros_like(accum)
        for s in range(cfg.spp):
            planes = render(tables, one, frame, sample0=s)
            resolve(planes, texture, cfg, total, sum_into=True)
        return accumulate_frame(accum, total * float(np.float32(1.0 / cfg.spp)),
                                frame)

    return step
