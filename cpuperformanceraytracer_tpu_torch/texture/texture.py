"""Environment texture and the deferred equirect lookup.

Counterpart of the slice's part of ``cpuperformanceraytracer_tpu.texture
.texture``. A ``Texture`` holds three flat (H*W,) f32 channel planes.
The lookup is the JAX one step for step:

1. optional (-x, y, -z) flip of the miss direction;
2. ``equirect_uv``: fract((atan2(z,x), asin(y)) * (0.1591, 0.3183) + .5),
   saturated (the truncated constants are the reference's, on purpose);
3. the flat texel index: stochastic ``floor(row+jr)*W + floor(col+jc)``
   with NO row/column clamp, or nearest with a clamped truncation;
4. ``gather_texels``: the index is clamped to [0, H*W-1] as a FLAT
   index (JAX's clip-mode gather), so u = 1 can wrap into the first
   texel of the next row and only an index past the end is clamped.
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


def load_texture(path: str, device="cpu") -> Texture:
    """Radiance .hdr file, flipped vertically as the reference loads it."""
    return texture_from_array(read_hdr(path, flip_vertical=True), device)


def equirect_uv(direction: Vec3) -> Tuple[torch.Tensor, torch.Tensor]:
    u = torch.atan2(direction.z, direction.x) * INV_ATAN[0] + 0.5
    v = torch.asin(torch.clamp(direction.y, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    return torch.clamp(u, 0.0, 1.0), torch.clamp(v, 0.0, 1.0)


def stochastic_flat_index(tex: Texture, u, v, jr, jc) -> torch.Tensor:
    """Jittered-nearest flat index (no clamp; see the module note)."""
    row = v * float(tex.height - 1)
    col = u * float(tex.width - 1)
    rand_row = torch.floor(row + jr).to(torch.int64)
    rand_col = torch.floor(col + jc).to(torch.int64)
    return rand_row * tex.width + rand_col


def env_texel_flat_index(tex: Texture, direction: Vec3, cfg, jr, jc):
    """Flat texel index of the deferred env lookup of ``direction``
    (equirect, stochastic or nearest), before the flat clamp."""
    if cfg.env_mode != "equirect":
        raise NotImplementedError(
            f"env_mode {cfg.env_mode!r}: only the equirect lookup is ported")
    d = (Vec3(-direction.x, direction.y, -direction.z)
         if cfg.env_flip_xz else direction)
    u, v = equirect_uv(d)
    if cfg.env_sampling == "stochastic":
        return stochastic_flat_index(tex, u, v, jr, jc)
    if cfg.env_sampling != "nearest":
        raise NotImplementedError(
            f"env_sampling {cfg.env_sampling!r} is not ported")
    row = torch.clamp((v * float(tex.height - 1)).to(torch.int64),
                      0, tex.height - 1)
    col = torch.clamp((u * float(tex.width - 1)).to(torch.int64),
                      0, tex.width - 1)
    return row * tex.width + col


def gather_texels(tex: Texture, flat_idx) -> Vec3:
    """Texel fetch with the flat index clamped to [0, H*W-1]."""
    idx = torch.clamp(flat_idx, 0, tex.width * tex.height - 1)
    return Vec3(tex.r[idx], tex.g[idx], tex.b[idx])


def sample_environment_deferred(tex: Texture, direction: Vec3, cfg,
                                jr, jc) -> Vec3:
    """Miss radiance for the deferred once-per-path env lookup."""
    return gather_texels(tex, env_texel_flat_index(tex, direction, cfg,
                                                   jr, jc))
