"""Vec2 and Vec3 as same-shape tensors, and the shading vector math.

Counterpart of ``cpuperformanceraytracer_tpu.core.vecmath``: each
component is one tensor over pixels (struct of arrays), and every select
is ``torch.where``. Operation order follows the JAX functions term by
term (``dot3`` sums x, y, z left to right), so the float results agree
bit for bit wherever both sides use exact division and sqrt.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec2(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x + o.x, self.y + o.y)
        return Vec2(self.x + o, self.y + o)

    def __sub__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x - o.x, self.y - o.y)
        return Vec2(self.x - o, self.y - o)

    def __mul__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x * o.x, self.y * o.y)
        return Vec2(self.x * o, self.y * o)

    __radd__ = __add__
    __rmul__ = __mul__


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


def vec2(x, y) -> Vec2:
    """A Vec2 of f32 tensors (a tensor keeps its device)."""
    return Vec2(torch.as_tensor(x, dtype=torch.float32),
                torch.as_tensor(y, dtype=torch.float32))


def vec3(x, y=None, z=None) -> Vec3:
    """A Vec3 of f32 tensors; ``vec3(a)`` is (a, a, a)."""
    if y is None:
        y = z = x
    return Vec3(*(torch.as_tensor(c, dtype=torch.float32) for c in (x, y, z)))


def from_array(a: torch.Tensor) -> Vec3:
    """Unstack a (..., 3) tensor into a Vec3."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def where3(cond, new: Vec3, old: Vec3) -> Vec3:
    return Vec3(torch.where(cond, new.x, old.x),
                torch.where(cond, new.y, old.y),
                torch.where(cond, new.z, old.z))


def dot2(u: Vec2, v: Vec2):
    return u.x * v.x + u.y * v.y


def dot3(u: Vec3, v: Vec3):
    return u.x * v.x + u.y * v.y + u.z * v.z


def cross(u: Vec3, v: Vec3) -> Vec3:
    return Vec3(u.y * v.z - u.z * v.y,
                u.z * v.x - u.x * v.z,
                u.x * v.y - u.y * v.x)


def length(v: Vec3):
    return torch.sqrt(dot3(v, v))


def lerp(u, v, t):
    return u + t * (v - u)


def lerp3(u: Vec3, v: Vec3, t) -> Vec3:
    return u + (v - u) * t


def saturate(x):
    return torch.clamp(torch.as_tensor(x), 0.0, 1.0)


def saturate3(v: Vec3) -> Vec3:
    return Vec3(saturate(v.x), saturate(v.y), saturate(v.z))


def normalize(v: Vec3) -> Vec3:
    """Exact-division normalize (no rsqrt), as the JAX ``normalize``."""
    return v * (1.0 / torch.sqrt(dot3(v, v)))


def safe_normalize(v: Vec3) -> Vec3:
    """``normalize`` with the squared length floored at 1e-20, as the
    megakernel's ``_safe_normalize``."""
    return v * (1.0 / torch.sqrt(torch.clamp(dot3(v, v), min=1e-20)))


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect: v - 2*dot(v,n)*n."""
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
    """Schlick Fresnel with the dense-to-rare TIR branch (exact
    division; grazing incidence lands on the TIR side, as in JAX)."""
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
