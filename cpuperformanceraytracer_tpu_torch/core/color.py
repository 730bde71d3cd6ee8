"""Display transform: exposure, ACES filmic tonemap, sRGB encode, u8.

Counterpart of ``cpuperformanceraytracer_tpu.core.color`` with the same
exact math (no fast-gamma tricks).
"""

from __future__ import annotations

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3, saturate, saturate3


def aces_film(v: Vec3) -> Vec3:
    """Narkowicz ACES approximation, saturated."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14

    def f(x):
        return saturate((x * (a * x + b)) / (x * (c * x + d) + e))

    return Vec3(f(v.x), f(v.y), f(v.z))


def linear_to_srgb(v: Vec3) -> Vec3:
    v = saturate3(v)

    def f(x):
        lo = x * 12.92
        hi = 1.055 * torch.pow(torch.clamp(x, min=1e-10), 1.0 / 2.4) - 0.055
        return torch.where(x < 0.0031308, lo, hi)

    return Vec3(f(v.x), f(v.y), f(v.z))


def srgb_to_linear(v: Vec3) -> Vec3:
    v = saturate3(v)

    def f(x):
        lo = x / 12.92
        hi = torch.pow((x + 0.055) / 1.055, 2.4)
        return torch.where(x < 0.04045, lo, hi)

    return Vec3(f(v.x), f(v.y), f(v.z))


def postprocess_color(v: Vec3, exposure: float = 1.0) -> Vec3:
    return linear_to_srgb(aces_film(v * exposure))


def to_u8(v: Vec3) -> torch.Tensor:
    """Saturate, scale by 255, round half to even, stack as (..., 3) u8."""
    s = saturate3(v) * 255.0
    return torch.round(torch.stack([s.x, s.y, s.z], dim=-1)).to(torch.uint8)
