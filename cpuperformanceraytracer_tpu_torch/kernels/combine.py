"""Kernel F: the multi-sample env combine plus the progressive
accumulate, and its plain version.

Replaces ``cpuperformanceraytracer_tpu/kernels/combine.py
::combine_accumulate`` with the same contract (``csrc/combine.cu``):

    spp = 1:  color_c = rgb_c + env_c * thr_c
    spp > 1:  color_c = rgb_c + (sum_s env_{s,c} * thr_{s,c}) * (1/spp)
    accum_c += (color_c - accum_c) * blend          (in place)

- ``e4``: kernel E's rows, (P, 4) for spp = 1 or (spp, P, 4);
- ``rgb``: kernel A's rgb planes, (3, H, W) or (spp, 3, H, W), whose
  mean is taken as kernel A takes it (sum_s rgb_s * (1/spp), in order);
- ``thr``: the miss throughput, (3, H, W) or (spp, 3, H, W);
- ``accum``: the (3, H, W) f32 accumulator, updated in place.

``rgb`` and ``thr`` may be views into kernel A's (spp, 12, H, W) buffer
(``buf[:, 0:3]``, ``buf[:, 6:9]``): each (3, H, W) slab must be dense,
the sample stride is free. The plain version also takes the JAX
kernel's form, a (3, H, W) ``rgb`` that is already the sample mean with
a (spp, P, 4) ``e4``; the CUDA kernel takes per-sample planes only. The
wrapper takes the plain version for a CPU tensor and launches the kernel
for a CUDA tensor (counted in ``combine_accumulate.launches``); any
other device raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library


def inv_spp(spp: int) -> float:
    return float(np.float32(1.0 / spp))


def combine_accumulate_reference(e4, rgb, thr, accum, blend: float):
    """Plain-torch kernel F (same contract as ``combine_accumulate``)."""
    h, w = accum.shape[1:]
    if e4.dim() == 2:
        env = e4[:, :3].t().reshape(3, h, w)
        color = rgb + env * thr
    else:
        spp = e4.shape[0]
        inv = inv_spp(spp)
        env_sum = torch.zeros_like(accum)
        for s in range(spp):
            env_sum = env_sum + e4[s, :, :3].t().reshape(3, h, w) * thr[s]
        if rgb.dim() == 4:
            mean = torch.zeros_like(accum)
            for s in range(spp):
                mean = mean + rgb[s] * inv
            rgb = mean
        color = rgb + env_sum * inv
    accum += (color - accum) * blend
    return accum


def _slabs(x, lead: int, h: int, w: int, what: str) -> int:
    """Check a (3, H, W) or (lead, 3, H, W) f32 view whose slabs are
    dense; return its sample stride in floats (0 without a sample axis)."""
    shape = (3, h, w) if x.dim() == 3 else (lead, 3, h, w)
    if tuple(x.shape) != shape or x.dtype != torch.float32 \
            or x.stride()[-3:] != (h * w, w, 1):
        raise ValueError(f"combine_accumulate: {what} {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()}, want {shape} "
                         "with dense (3, H, W) slabs")
    return x.stride(0) if x.dim() == 4 else 0


def combine_accumulate(e4, rgb, thr, accum, blend: float):
    """Kernel F wrapper; updates ``accum`` in place and returns it."""
    if accum.device.type == "cpu":
        return combine_accumulate_reference(e4, rgb, thr, accum, blend)
    if accum.device.type != "cuda":
        raise ValueError(f"combine_accumulate: unsupported device {accum.device}")
    dev = accum.device
    if accum.dim() != 3 or accum.shape[0] != 3 \
            or accum.dtype != torch.float32 or not accum.is_contiguous():
        raise ValueError(f"combine_accumulate: accum {tuple(accum.shape)} "
                         f"{accum.dtype}")
    h, w = accum.shape[1:]
    n = h * w
    multi = e4.dim() == 3
    spp = e4.shape[0] if multi else 1
    if e4.shape[-2:] != (n, 4) or e4.dim() not in (2, 3) \
            or e4.dtype != torch.float32 or e4.stride()[-2:] != (4, 1) \
            or (multi and e4.stride(0) % 4) or e4.data_ptr() % 16:
        raise ValueError(f"combine_accumulate: e4 {tuple(e4.shape)} "
                         f"{e4.dtype} strides {e4.stride()}")
    if rgb.dim() != e4.dim() + 1 or thr.dim() != e4.dim() + 1:
        raise ValueError("combine_accumulate: rgb and thr need a sample axis "
                         "exactly when e4 has one (per-sample planes)")
    rgb_stride = _slabs(rgb, spp, h, w, "rgb")
    thr_stride = _slabs(thr, spp, h, w, "thr")
    if any(t.device != dev for t in (e4, rgb, thr)):
        raise ValueError("combine_accumulate: tensors on different devices")
    err = load_library().cprt_combine(
        e4.data_ptr(), e4.stride(0) if multi else 0, rgb.data_ptr(),
        rgb_stride, thr.data_ptr(), thr_stride, accum.data_ptr(), n, spp,
        ctypes.c_float(inv_spp(spp)), ctypes.c_float(blend),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "combine_accumulate")
    combine_accumulate.launches += 1
    return accum


combine_accumulate.launches = 0
