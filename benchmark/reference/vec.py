"""Vec3 as three same-shape tensors, and the shading vector math.

A frozen copy of the tracer's vector math, written term by term in the
order the CUDA kernels compute it (``dot3`` sums x, y, z left to right;
exact division and sqrt, no reciprocal square root). Every function keeps
the dtype of its inputs, so the same code runs in float32 (the reference)
and bfloat16 (the lower-precision control).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    __radd__ = __add__
    __rmul__ = __mul__


def cols(a: torch.Tensor) -> Vec3:
    """The columns of an (N, 3) tensor."""
    return Vec3(*a.unbind(-1))


def where3(cond, new: Vec3, old: Vec3) -> Vec3:
    return Vec3(torch.where(cond, new.x, old.x),
                torch.where(cond, new.y, old.y),
                torch.where(cond, new.z, old.z))


def dot3(u: Vec3, v: Vec3):
    return u.x * v.x + u.y * v.y + u.z * v.z


def cross(u: Vec3, v: Vec3) -> Vec3:
    return Vec3(u.y * v.z - u.z * v.y,
                u.z * v.x - u.x * v.z,
                u.x * v.y - u.y * v.x)


def normalize(v: Vec3) -> Vec3:
    return v * (1.0 / torch.sqrt(dot3(v, v)))


def safe_normalize(v: Vec3) -> Vec3:
    """``normalize`` with the squared length floored at 1e-20."""
    return v * (1.0 / torch.sqrt(torch.clamp(dot3(v, v), min=1e-20)))


def reflect(v: Vec3, n: Vec3) -> Vec3:
    return v - n * (2.0 * dot3(v, n))


def refract(v: Vec3, n: Vec3, eta) -> Vec3:
    """GLSL refract; the zero vector on total internal reflection."""
    vdotn = dot3(v, n)
    k = 1.0 - eta * eta * (1.0 - vdotn * vdotn)
    sqrt_k = torch.where(k > 0.0, torch.sqrt(torch.where(k > 0.0, k, 1.0)),
                         0.0)
    out = v * eta - n * (eta * vdotn + sqrt_k)
    tir = k < 0.0
    return Vec3(torch.where(tir, 0.0, out.x), torch.where(tir, 0.0, out.y),
                torch.where(tir, 0.0, out.z))


def fresnel_reflect_amount(n1, n2, normal: Vec3, incident: Vec3, f0, f90):
    """Schlick Fresnel with the dense-to-rare total-internal-reflection
    branch (grazing incidence lands on the reflection side)."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot3(normal, incident)
    n1_gt_n2 = n1 > n2
    n = n1 / n2
    sin_t2_compl = 1.0 - (n * n) * (1.0 - cos_x * cos_x)
    tir = sin_t2_compl <= 0.0
    new_cos_x = torch.where(
        tir, 0.0, torch.sqrt(torch.where(tir, 1.0, sin_t2_compl)))
    cos_x = torch.where(n1_gt_n2 & ~tir, new_cos_x, cos_x)
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x * x * x * x * x
    ret = torch.where(n1_gt_n2 & tir, 1.0, ret)
    return f0 + (f90 - f0) * ret
