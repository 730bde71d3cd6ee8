"""Kernel G: the display transform, and its plain version.

Replaces ``cpuperformanceraytracer_tpu/kernels/tonemap.py
::postprocess_pallas`` (``csrc/tonemap.cu``): exposure, ACES, sRGB over
a (3, H, W) f32 accumulator of any H and W, into (3, H, W) f32 display
values in [0, 1]. The plain version is ``core.color.postprocess_color``;
the round to u8 (``core.color.to_u8``) stays outside the kernel, as in
the JAX package.

``tonemap`` is the wrapper: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (counted in ``tonemap.launches``); any other
device raises.
"""

from __future__ import annotations

import ctypes

import torch

from cpuperformanceraytracer_tpu_torch.core.color import postprocess_color
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library


def tonemap_reference(accum, exposure: float = 1.0) -> torch.Tensor:
    return torch.stack(postprocess_color(Vec3(*accum), exposure))


def tonemap(accum, exposure: float = 1.0) -> torch.Tensor:
    """Kernel G wrapper: (3, H, W) f32 display values."""
    if accum.device.type == "cpu":
        return tonemap_reference(accum, exposure)
    if accum.device.type != "cuda":
        raise ValueError(f"tonemap: unsupported device {accum.device}")
    if accum.dim() != 3 or accum.shape[0] != 3 \
            or accum.dtype != torch.float32 or not accum.is_contiguous():
        raise ValueError(f"tonemap: accum {tuple(accum.shape)} {accum.dtype}")
    out = torch.empty_like(accum)
    if accum.numel() == 0:
        return out
    err = load_library().cprt_tonemap(
        accum.data_ptr(), out.data_ptr(), accum.numel(),
        ctypes.c_float(exposure),
        torch.cuda.current_stream(accum.device).cuda_stream)
    check(err, "tonemap")
    tonemap.launches += 1
    return out


tonemap.launches = 0
