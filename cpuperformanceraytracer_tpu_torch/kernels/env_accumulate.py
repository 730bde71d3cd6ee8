"""Kernel B: deferred env resolve + progressive accumulate, and its plain
version.

Replaces, on the JAX main path, ``texture.env_texel_flat_index`` +
``texture._gather`` + the combine ``rgb + env * miss_thr``
(``megakernel.py:1163``) + ``render.frame.accumulate_frame``: XLA ops
around the TPU megakernel, one fused memory-bound pass here
(``csrc/env_accumulate.cu``). It reads kernel A's (12, H, W) planes and
updates the planar (3, H, W) accumulator IN PLACE:

    accum += (color - accum) * blend      (progressive mean)

With env_mode "none" the ambient was already added by kernel A and
``color = rgb``. ``index_out`` (optional int64 (H, W)) receives the
clamped flat texel index (the diff path's backward reads it).
The env map is an equirect map or a cubemap, looked up with one tap
(stochastic or nearest). ``env_color_reference`` is the functional form
of the same resolve.

``env_accumulate`` is the wrapper: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel (counted in
``env_accumulate.launches``); any other device raises.

A pixel-row window of the frame (``parallel/shard.py``) needs nothing
here: the kernel works pixel by pixel on planes kernel A has already
keyed and cast by global row, so it takes a window's (12, h, W) planes
with a config of height h.
"""

from __future__ import annotations

import ctypes

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library
from cpuperformanceraytracer_tpu_torch.texture.texture import (
    env_texel_flat_index,
    gather_texels,
)


def env_color_reference(planes, texture, cfg):
    """The resolved colour of kernel A's planes, functionally: returns
    ((3, H, W) colour, flat texel index or None). Nothing is updated in
    place, so autograd differentiates through it to the planes and the
    texel planes (the gather): the plain forward of the diff path."""
    r, g, b = planes[0], planes[1], planes[2]
    if cfg.env_mode == "none":
        return torch.stack([r, g, b]), None
    idx = env_texel_flat_index(texture, Vec3(*planes[3:6]), cfg, planes[9],
                               planes[10])
    idx = torch.clamp(idx, 0, texture.width * texture.height - 1)
    env = gather_texels(texture, idx)
    return torch.stack([r + env.x * planes[6], g + env.y * planes[7],
                        b + env.z * planes[8]]), idx


def env_accumulate_reference(planes, texture, cfg, accum, blend: float = 1.0,
                             index_out=None):
    """Plain-torch kernel B (same contract as ``env_accumulate``)."""
    color, idx = env_color_reference(planes, texture, cfg)
    if index_out is not None and idx is not None:
        index_out.copy_(idx)
    for c in range(3):
        accum[c] += (color[c] - accum[c]) * blend
    return accum


def _check(planes, texture, cfg, accum, index_out):
    dev = planes.device
    h, w = cfg.height, cfg.width
    bad = []
    if planes.shape != (12, h, w) or planes.dtype != torch.float32 \
            or not planes.is_contiguous():
        bad.append(f"planes {tuple(planes.shape)} {planes.dtype}")
    if accum.shape != (3, h, w) or accum.dtype != torch.float32 \
            or not accum.is_contiguous() or accum.device != dev:
        bad.append(f"accum {tuple(accum.shape)} {accum.dtype} {accum.device}")
    if cfg.env_mode != "none":
        for t in (texture.r, texture.g, texture.b):
            if t.device != dev or t.dtype != torch.float32 \
                    or not t.is_contiguous() \
                    or t.numel() != texture.width * texture.height:
                bad.append(f"texture plane {tuple(t.shape)} {t.device}")
    if index_out is not None and (
            index_out.shape != (h, w) or index_out.dtype != torch.int64
            or not index_out.is_contiguous() or index_out.device != dev):
        bad.append(f"index_out {tuple(index_out.shape)} {index_out.dtype}")
    if bad:
        raise ValueError("env_accumulate: " + "; ".join(bad))


def env_accumulate(planes, texture, cfg, accum, blend: float = 1.0,
                   index_out=None):
    """Kernel B wrapper; updates ``accum`` in place and returns it."""
    if planes.device.type == "cpu":
        return env_accumulate_reference(planes, texture, cfg, accum, blend,
                                        index_out)
    if planes.device.type != "cuda":
        raise ValueError(f"env_accumulate: unsupported device {planes.device}")
    if cfg.env_mode != "none" and cfg.env_sampling not in ("stochastic",
                                                            "nearest"):
        raise NotImplementedError(
            f"env_accumulate: env_mode {cfg.env_mode!r} with sampling "
            f"{cfg.env_sampling!r} is not ported")
    _check(planes, texture, cfg, accum, index_out)
    env = cfg.env_mode != "none"
    n = cfg.height * cfg.width
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = load_library().cprt_env_accumulate(
        planes.data_ptr(), n,
        texture.r.data_ptr() if env else None,
        texture.g.data_ptr() if env else None,
        texture.b.data_ptr() if env else None,
        texture.width if env else 0, texture.height if env else 0,
        accum.data_ptr(), ctypes.c_float(blend), int(env),
        int(cfg.env_mode == "cubemap"), int(cfg.env_sampling == "stochastic"),
        int(cfg.env_flip_xz),
        None if index_out is None else index_out.data_ptr(), stream)
    check(err, "env_accumulate")
    # a launch, not a capture into a CUDA graph: its replays launch
    if not torch.cuda.is_current_stream_capturing():
        env_accumulate.launches += 1
    return accum


env_accumulate.launches = 0
