"""Host-side scene construction (counterpart of the JAX ``SceneBuilder``).

Materials are referenced by explicit index. ``grey_albedo_bug=True``
reproduces the reference builder's bug of copying albedo.x into all
three channels; it is off by default.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.scene.types import (
    Material,
    Materials,
    Quads,
    Scene,
    Spheres,
)


def _vec3_stack(points, device) -> Vec3:
    a = torch.as_tensor(np.asarray(points, np.float32).reshape(-1, 3),
                        device=device)
    return Vec3(a[:, 0].contiguous(), a[:, 1].contiguous(),
                a[:, 2].contiguous())


class SceneBuilder:
    def __init__(self, translation=(0.0, 0.0, 0.0),
                 grey_albedo_bug: bool = False):
        """``translation`` offsets every quad vertex and sphere center
        added with ``translate=True``."""
        self._t = np.asarray(translation, np.float32)
        self._grey_bug = grey_albedo_bug
        self._materials: List[Material] = []
        self._quads: List[tuple] = []
        self._spheres: List[tuple] = []

    def add_material(self, m: Material) -> int:
        if self._grey_bug:
            a = m.albedo[0]
            m = dataclasses.replace(m, albedo=(a, a, a))
        self._materials.append(m)
        return len(self._materials) - 1

    def add_quad(self, v0, v1, v2, v3, material: int,
                 translate: bool = True) -> int:
        t = self._t if translate else 0.0
        vs = [np.asarray(v, np.float32) + t for v in (v0, v1, v2, v3)]
        self._quads.append((*vs, material))
        return len(self._quads) - 1

    def add_sphere(self, center, radius: float, material: int,
                   translate: bool = True) -> int:
        t = self._t if translate else 0.0
        c = np.asarray(center, np.float32) + t
        self._spheres.append((c, float(radius), material))
        return len(self._spheres) - 1

    def build(self, device="cpu") -> Scene:
        if not self._quads:
            # keep every table non-empty: one degenerate far-away quad
            self.add_quad(
                (1e7, 1e7, 1e7), (1e7 + 1, 1e7, 1e7),
                (1e7 + 1, 1e7 + 1, 1e7), (1e7, 1e7 + 1, 1e7), 0,
                translate=False)
        if not self._spheres:
            self.add_sphere((1e7, 1e7, 1e7), 1e-3, 0, translate=False)
        if not self._materials:
            self.add_material(Material())

        def ints(vals):
            return torch.as_tensor(vals, dtype=torch.int64, device=device)

        def f(get):
            return torch.as_tensor([get(m) for m in self._materials],
                                   dtype=torch.float32, device=device)

        def f3(get):
            return _vec3_stack([get(m) for m in self._materials], device)

        qs, ss = self._quads, self._spheres
        quads = Quads(*(_vec3_stack([q[i] for q in qs], device)
                        for i in range(4)),
                      material=ints([q[4] for q in qs]))
        spheres = Spheres(
            center=_vec3_stack([s[0] for s in ss], device),
            radius=torch.as_tensor([s[1] for s in ss], dtype=torch.float32,
                                   device=device),
            material=ints([s[2] for s in ss]))
        materials = Materials(
            albedo=f3(lambda m: m.albedo),
            emissive=f3(lambda m: m.emissive),
            specular_chance=f(lambda m: m.specular_chance),
            specular_roughness=f(lambda m: m.specular_roughness),
            specular_color=f3(lambda m: m.specular_color),
            ior=f(lambda m: m.ior),
            refraction_chance=f(lambda m: m.refraction_chance),
            refraction_roughness=f(lambda m: m.refraction_roughness),
            refraction_color=f3(lambda m: m.refraction_color),
        )
        return Scene(quads=quads, spheres=spheres, materials=materials)
