"""Kernel E: the deferred env lookup and the texel fetch, and their plain
versions.

Replaces ``cpuperformanceraytracer_tpu/kernels/env_gather.py::_env_gather``
(the MXU one-hot gather) and, on the textured multi-sample path, the XLA
lookup ``texture.sample_environment_deferred`` around the TPU
megakernel. One CUDA source (``csrc/env_gather.cu``), two entry points:

- ``gather_texels(tex, rows, cols)``: (N, 4) f32 RGBX rows of
  ``tex[rows, cols]``, row and column each clamped to its axis; int32 or
  int64 index vectors. Exact f32: the bf16 hi/lo split of the TPU kernel
  is not ported.
- ``env_lookup(planes, texture, cfg)``: the env radiance at kernel A's
  first-miss direction (planes 3-5) with its jitter (planes 9-10), for
  every env_mode x env_sampling pair (``texture.py`` has the contract),
  as (P, 4) f32 RGBX rows, pad channel 0. ``out`` may be a slot of a
  (spp, P, 4) buffer; ``taps_out`` (P, 4) int64 receives the clamped
  flat indices of the taps (see ``texture.env_tap_indices``).

Each wrapper takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (counted in ``<wrapper>.launches``); any other
device raises.
"""

from __future__ import annotations

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library
from cpuperformanceraytracer_tpu_torch.texture.texture import (
    env_tap_indices,
    sample_environment_deferred,
    texel_fetch,
)

_SAMPLING = {"stochastic": 0, "nearest": 1, "bilinear": 2}


def _rgbx(c: Vec3) -> torch.Tensor:
    return torch.stack([c.x, c.y, c.z, torch.zeros_like(c.x)], dim=-1)


def gather_texels_reference(tex, rows, cols) -> torch.Tensor:
    return _rgbx(texel_fetch(tex, rows.to(torch.int64), cols.to(torch.int64)))


def _check_texture(tex, dev, what):
    for t in (tex.r, tex.g, tex.b):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.numel() != tex.width * tex.height:
            raise ValueError(f"{what}: texture plane {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")


def gather_texels(tex, rows, cols) -> torch.Tensor:
    """Kernel E's texel fetch: (N, 4) f32 rows of ``tex[rows, cols]``."""
    if rows.device.type == "cpu":
        return gather_texels_reference(tex, rows, cols)
    if rows.device.type != "cuda":
        raise ValueError(f"gather_texels: unsupported device {rows.device}")
    dev, n = rows.device, rows.numel()
    if rows.dim() != 1 or cols.shape != rows.shape or cols.dtype != rows.dtype \
            or rows.dtype not in (torch.int32, torch.int64) \
            or not (rows.is_contiguous() and cols.is_contiguous()) \
            or cols.device != dev:
        raise ValueError(f"gather_texels: rows {tuple(rows.shape)} "
                         f"{rows.dtype}, cols {tuple(cols.shape)} {cols.dtype}")
    _check_texture(tex, dev, "gather_texels")
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = load_library().cprt_gather_texels(
        tex.r.data_ptr(), tex.g.data_ptr(), tex.b.data_ptr(), tex.width,
        tex.height, rows.data_ptr(), cols.data_ptr(),
        int(rows.dtype == torch.int64), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gather_texels")
    gather_texels.launches += 1
    return out


gather_texels.launches = 0


def env_lookup_reference(planes, texture, cfg, out=None, taps_out=None):
    """Plain-torch kernel E (same contract as ``env_lookup``)."""
    d = Vec3(*(planes[i].reshape(-1) for i in (3, 4, 5)))
    jr, jc = planes[9].reshape(-1), planes[10].reshape(-1)
    rows = _rgbx(sample_environment_deferred(texture, d, cfg, jr, jc))
    if taps_out is not None:
        taps_out.copy_(env_tap_indices(texture, d, cfg, jr, jc))
    if out is None:
        return rows
    return out.copy_(rows)


def env_lookup(planes, texture, cfg, out=None, taps_out=None):
    """Kernel E wrapper: (P, 4) f32 env rows of one sample's planes."""
    if planes.device.type == "cpu":
        return env_lookup_reference(planes, texture, cfg, out, taps_out)
    if planes.device.type != "cuda":
        raise ValueError(f"env_lookup: unsupported device {planes.device}")
    dev = planes.device
    h, w = cfg.height, cfg.width
    n = h * w
    if cfg.env_mode not in ("equirect", "cubemap") or texture is None:
        raise ValueError(f"env_lookup: env_mode {cfg.env_mode!r} needs an "
                         "equirect or cubemap texture")
    if planes.shape != (12, h, w) or planes.dtype != torch.float32 \
            or not planes.is_contiguous():
        raise ValueError(f"env_lookup: planes {tuple(planes.shape)} "
                         f"{planes.dtype}")
    _check_texture(texture, dev, "env_lookup")
    if out is None:
        out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if out.shape != (n, 4) or out.dtype != torch.float32 \
            or not out.is_contiguous() or out.device != dev \
            or out.data_ptr() % 16:
        raise ValueError(f"env_lookup: out {tuple(out.shape)} {out.dtype} "
                         f"{out.device}")
    if taps_out is not None and (
            taps_out.shape != (n, 4) or taps_out.dtype != torch.int64
            or not taps_out.is_contiguous() or taps_out.device != dev):
        raise ValueError(f"env_lookup: taps_out {tuple(taps_out.shape)} "
                         f"{taps_out.dtype}")
    err = load_library().cprt_env_lookup(
        planes.data_ptr(), n, texture.r.data_ptr(), texture.g.data_ptr(),
        texture.b.data_ptr(), texture.width, texture.height,
        int(cfg.env_mode == "cubemap"), _SAMPLING[cfg.env_sampling],
        int(cfg.env_flip_xz), out.data_ptr(),
        None if taps_out is None else taps_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "env_lookup")
    env_lookup.launches += 1
    return out


env_lookup.launches = 0
