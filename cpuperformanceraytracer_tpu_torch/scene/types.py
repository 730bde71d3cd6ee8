"""Scene containers: quads, spheres, SoA materials (tensors of (N,)).

Counterpart of ``cpuperformanceraytracer_tpu.scene.types``. The scene
stores primal parameters (quad vertices, sphere centers and radii,
material fields); ``precompute_quads`` derives the normals and the
dual-edge barycentric vectors that the kernel's quad test reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import (
    Vec3,
    cross,
    dot3,
    normalize,
)


@dataclass(frozen=True)
class Material:
    """Host-side material description."""

    albedo: tuple = (0.0, 0.0, 0.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    specular_chance: float = 0.0
    specular_roughness: float = 0.0
    specular_color: tuple = (0.0, 0.0, 0.0)
    ior: float = 1.0
    refraction_chance: float = 0.0
    refraction_roughness: float = 0.0
    refraction_color: tuple = (0.0, 0.0, 0.0)


class Materials(NamedTuple):
    """17 f32 (NM,) fields, in the kernel's material-table column order."""

    albedo: Vec3
    emissive: Vec3
    specular_chance: torch.Tensor
    specular_roughness: torch.Tensor
    specular_color: Vec3
    ior: torch.Tensor
    refraction_chance: torch.Tensor
    refraction_roughness: torch.Tensor
    refraction_color: Vec3


class Quads(NamedTuple):
    """Vertices v0..v3 (counter-clockwise: 0-1-2 and 0-2-3 triangles)
    and an int64 (NQ,) material index."""

    v0: Vec3
    v1: Vec3
    v2: Vec3
    v3: Vec3
    material: torch.Tensor


class QuadsDerived(NamedTuple):
    normal: Vec3
    nxv01: Vec3
    nxv12: Vec3
    nxv20: Vec3
    nxv02: Vec3
    nxv23: Vec3
    nxv30: Vec3


class Spheres(NamedTuple):
    center: Vec3
    radius: torch.Tensor
    material: torch.Tensor


class Scene(NamedTuple):
    quads: Quads
    spheres: Spheres
    materials: Materials


def precompute_quads(q: Quads) -> QuadsDerived:
    """Unit normal and determinant-scaled dual edges of both triangles:
    a hit point's barycentrics are then six dot products."""
    v01 = q.v1 - q.v0
    v02 = q.v2 - q.v0
    v30 = q.v0 - q.v3
    v20 = -v02
    v23 = q.v3 - q.v2
    v12 = q.v2 - q.v1

    v01xv02 = cross(v01, v02)
    v30xv01 = cross(v30, v01)
    n = normalize(v01xv02)

    inv_bot = 1.0 / dot3(v01xv02, n)
    inv_top = 1.0 / dot3(v30xv01, n)
    return QuadsDerived(
        normal=n,
        nxv01=cross(n, v01) * inv_bot,
        nxv12=cross(n, v12) * inv_bot,
        nxv20=cross(n, v20) * inv_bot,
        nxv02=cross(n, v02) * inv_top,
        nxv23=cross(n, v23) * inv_top,
        nxv30=cross(n, v30) * inv_top,
    )
