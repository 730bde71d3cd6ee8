"""Environment texture and the deferred env lookup.

Counterpart of ``cpuperformanceraytracer_tpu.texture.texture``. A
``Texture`` holds three flat (H*W,) f32 channel planes; a cubemap is six
W x H faces stacked vertically into one W x 6H texture, face order px,
nx, py, ny, pz, nz. The lookup is the JAX one step for step:

1. the uv of the miss direction: ``equirect_uv`` after an optional
   (-x, y, -z) flip, fract((atan2(z,x), asin(y)) * (0.1591, 0.3183) + .5)
   saturated (the truncated constants are the reference's, on purpose);
   or ``cubemap_uv`` of the UNFLIPPED direction (max-axis face select,
   ties X < Y < Z);
2. the taps at (row, col) = (v, u) * (dim - 1), in f32:
   - stochastic: ``floor(row+jr)*W + floor(col+jc)`` with NO row/column
     clamp; the gather clamps the FLAT index to [0, H*W-1] (JAX's
     clip-mode gather), so u = 1 can wrap into the first texel of the
     next row and only an index past the end is clamped;
   - nearest: the truncation of row and col, each clamped to its axis;
   - bilinear: floor/ceil of row and col, each clamped to its axis, du
     and dv from the floor corner (the ceil tap aliases the floor tap on
     an integer coordinate), lerped along u then v.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.texture.hdr import read_hdr

INV_ATAN = (0.1591, 0.3183)  # (1/2pi, 1/pi) truncated as in the reference


class Texture(NamedTuple):
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    width: int
    height: int


def texture_from_array(rgb, device="cpu") -> Texture:
    """(H, W, 3) array -> Texture with contiguous f32 planes on device."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    flat = torch.as_tensor(rgb.reshape(-1, 3), device=device)
    return Texture(flat[:, 0].contiguous(), flat[:, 1].contiguous(),
                   flat[:, 2].contiguous(), w, h)


def texture_to(texture: Texture, device) -> Texture:
    """The texture with contiguous planes on ``device``."""
    return Texture(*(t.to(device).contiguous() for t in texture[:3]),
                   texture.width, texture.height)


def load_texture(path: str, device="cpu") -> Texture:
    """Radiance .hdr file, flipped vertically as the reference loads it."""
    return texture_from_array(read_hdr(path, flip_vertical=True), device)


def load_cubemap_texture(paths, device="cpu") -> Texture:
    """Six .hdr faces (px, nx, py, ny, pz, nz) stacked vertically."""
    faces = [read_hdr(p, flip_vertical=True) for p in paths]
    if len(faces) != 6 or any(f.shape != faces[0].shape for f in faces):
        raise ValueError("a cubemap needs six faces of one resolution")
    return texture_from_array(np.concatenate(faces, axis=0), device)


def equirect_uv(direction: Vec3) -> Tuple[torch.Tensor, torch.Tensor]:
    u = torch.atan2(direction.z, direction.x) * INV_ATAN[0] + 0.5
    v = torch.asin(torch.clamp(direction.y, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    return torch.clamp(u, 0.0, 1.0), torch.clamp(v, 0.0, 1.0)


def cubemap_uv(direction: Vec3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-axis face select onto the stacked faces. Ties: an X face,
    overridden by Y when |y| >= |x|, overridden by Z when |z| >= |x| and
    |z| >= |y|."""
    d = direction
    ax, ay, az = torch.abs(d.x), torch.abs(d.y), torch.abs(d.z)
    xgt0 = d.x >= 0.0
    face_u = torch.where(xgt0, -d.z, d.z)
    face_v = d.y
    v_off = torch.where(xgt0, 0.0, 1.0 / 6.0)

    ygt0 = d.y >= 0.0
    ygtx = ay >= ax
    face_u = torch.where(ygtx, d.x, face_u)
    face_v = torch.where(ygtx, torch.where(ygt0, -d.z, d.z), face_v)
    v_off = torch.where(ygtx, torch.where(ygt0, 2.0 / 6.0, 3.0 / 6.0), v_off)

    zgt0 = d.z >= 0.0
    maxz = (az >= ax) & (az >= ay)
    face_u = torch.where(maxz, torch.where(zgt0, d.x, -d.x), face_u)
    face_v = torch.where(maxz, d.y, face_v)
    v_off = torch.where(maxz, torch.where(zgt0, 4.0 / 6.0, 5.0 / 6.0), v_off)

    max_abs = torch.maximum(ax, torch.maximum(ay, az))
    u = torch.clamp(face_u / max_abs * 0.5 + 0.5, 0.0, 1.0)
    v = torch.clamp(face_v / max_abs * 0.5 + 0.5, 0.0, 1.0)
    v = torch.clamp(v * (1.0 / 6.0) + v_off, 0.0, 1.0)
    return u, v


def env_uv(direction: Vec3, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uv of a miss direction under ``cfg.env_mode``."""
    if cfg.env_mode == "equirect":
        if cfg.env_flip_xz:
            direction = Vec3(-direction.x, direction.y, -direction.z)
        return equirect_uv(direction)
    if cfg.env_mode == "cubemap":
        return cubemap_uv(direction)
    raise ValueError(f"env_mode {cfg.env_mode!r} has no texture lookup")


def gather_texels(tex: Texture, flat_idx) -> Vec3:
    """Texel fetch with the flat index clamped to [0, H*W-1]."""
    idx = torch.clamp(flat_idx, 0, tex.width * tex.height - 1)
    return Vec3(tex.r[idx], tex.g[idx], tex.b[idx])


def texel_fetch(tex: Texture, row, col) -> Vec3:
    """Integer texel fetch with row and column clamped to their axes."""
    row = torch.clamp(row, 0, tex.height - 1)
    col = torch.clamp(col, 0, tex.width - 1)
    return gather_texels(tex, row * tex.width + col)


def _nearest_rc(tex: Texture, u, v):
    row = torch.clamp((v * float(tex.height - 1)).to(torch.int64),
                      0, tex.height - 1)
    col = torch.clamp((u * float(tex.width - 1)).to(torch.int64),
                      0, tex.width - 1)
    return row, col


def _bilinear_taps(tex: Texture, u, v):
    """(rows, cols, du, dv): the taps (r0, c0), (r0, c1), (r1, c0),
    (r1, c1), clamped to their axes, and the lerp weights."""
    row = v * float(tex.height - 1)
    col = u * float(tex.width - 1)
    r0, r1 = torch.floor(row), torch.ceil(row)
    c0, c1 = torch.floor(col), torch.ceil(col)
    dv, du = row - r0, col - c0

    def clamp(x, n):
        return torch.clamp(x.to(torch.int64), 0, n - 1)

    r0, r1 = clamp(r0, tex.height), clamp(r1, tex.height)
    c0, c1 = clamp(c0, tex.width), clamp(c1, tex.width)
    return (r0, r0, r1, r1), (c0, c1, c0, c1), du, dv


def stochastic_flat_index(tex: Texture, u, v, jr, jc) -> torch.Tensor:
    """Jittered-nearest flat index (no clamp; see the module note)."""
    row = v * float(tex.height - 1)
    col = u * float(tex.width - 1)
    rand_row = torch.floor(row + jr).to(torch.int64)
    rand_col = torch.floor(col + jc).to(torch.int64)
    return rand_row * tex.width + rand_col


def sample_nearest(tex: Texture, u, v) -> Vec3:
    return texel_fetch(tex, *_nearest_rc(tex, u, v))


def sample_bilinear(tex: Texture, u, v) -> Vec3:
    rows, cols, du, dv = _bilinear_taps(tex, u, v)
    c00, c10, c01, c11 = (texel_fetch(tex, r, c) for r, c in zip(rows, cols))
    top = c00 + (c10 - c00) * du
    bot = c01 + (c11 - c01) * du
    return top + (bot - top) * dv


def sample_stochastic_with_jitter(tex: Texture, u, v, jr, jc) -> Vec3:
    """The stochastic single tap with the caller's jitter in [0, 1)^2."""
    return gather_texels(tex, stochastic_flat_index(tex, u, v, jr, jc))


def env_texel_flat_index(tex: Texture, direction: Vec3, cfg, jr, jc):
    """Flat texel index of a single-tap env lookup (stochastic, before
    the flat clamp; or nearest). Bilinear has four taps and raises here:
    see ``env_tap_indices``."""
    u, v = env_uv(direction, cfg)
    if cfg.env_sampling == "stochastic":
        return stochastic_flat_index(tex, u, v, jr, jc)
    if cfg.env_sampling == "nearest":
        row, col = _nearest_rc(tex, u, v)
        return row * tex.width + col
    raise ValueError(f"env_sampling {cfg.env_sampling!r} has four taps, "
                     "not one flat index")


def env_tap_indices(tex: Texture, direction: Vec3, cfg, jr, jc):
    """(..., 4) int64 clamped flat indices of the taps of the deferred
    env lookup: the four bilinear taps in the order (r0, c0), (r0, c1),
    (r1, c0), (r1, c1), or the single tap four times."""
    if cfg.env_sampling == "bilinear":
        rows, cols, _, _ = _bilinear_taps(tex, *env_uv(direction, cfg))
        return torch.stack([r * tex.width + c for r, c in zip(rows, cols)],
                           dim=-1)
    idx = torch.clamp(env_texel_flat_index(tex, direction, cfg, jr, jc),
                      0, tex.width * tex.height - 1)
    return torch.stack([idx] * 4, dim=-1)


def env_draws_per_bounce(tex, cfg) -> int:
    """RNG draws the env path consumes per bounce iteration (the stream
    contract of ``render/integrator.py``): 2 for a stochastic lookup of a
    texture, else 0."""
    if cfg.env_mode == "none" or tex is None or cfg.env_sampling != "stochastic":
        return 0
    return 2


def sample_environment_deferred(tex, direction: Vec3, cfg, jr, jc) -> Vec3:
    """Miss radiance of the deferred once-per-path env lookup, for every
    env_mode x env_sampling pair (jr, jc are read only by stochastic)."""
    if cfg.env_mode == "none" or tex is None:
        return Vec3(*(torch.full_like(direction.x, a) for a in cfg.ambient))
    u, v = env_uv(direction, cfg)
    if cfg.env_sampling == "stochastic":
        return sample_stochastic_with_jitter(tex, u, v, jr, jc)
    if cfg.env_sampling == "bilinear":
        return sample_bilinear(tex, u, v)
    return sample_nearest(tex, u, v)


def bilinear_resample(rgb: np.ndarray, out_width: int,
                      out_height: int) -> np.ndarray:
    """Pixel-center bilinear resample of an (H, W, 3) image: sample at
    (col+0.5)/out_w scaled into source texel space, lerp the 2x2
    neighbourhood, clamp edge taps (the JAX package's semantics)."""
    src = np.asarray(rgb, np.float32)
    h, w = src.shape[:2]
    u = (np.arange(out_width, dtype=np.float32) + 0.5) / out_width * w - 0.5
    v = (np.arange(out_height, dtype=np.float32) + 0.5) / out_height * h - 0.5
    u0 = np.clip(np.floor(u).astype(np.int64), 0, w - 1)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, h - 1)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    du = np.clip(u - u0, 0.0, 1.0)[None, :, None]
    dv = np.clip(v - v0, 0.0, 1.0)[:, None, None]
    c00 = src[v0[:, None], u0[None, :]]
    c10 = src[v0[:, None], u1[None, :]]
    c01 = src[v1[:, None], u0[None, :]]
    c11 = src[v1[:, None], u1[None, :]]
    top = c00 + (c10 - c00) * du
    bot = c01 + (c11 - c01) * du
    return top + (bot - top) * dv
