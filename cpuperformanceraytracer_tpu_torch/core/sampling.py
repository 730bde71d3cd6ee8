"""Unit-vector samplers for bounce directions (same draw counts as the
JAX ``core.sampling``, so RNG streams stay aligned):

- ``random_unit_vector_zangle``: z = 2u-1, a = 2*pi*v; 2 draws.
- ``random_unit_vector_normalized3``: three uniforms in [-1,1)^3
  normalized with an exact 1/sqrt; 3 draws.

Both take and return an rng with ``next01``.
"""

from __future__ import annotations

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3

TWO_PI = 6.28318530718


def random_unit_vector_zangle(rng):
    wide_z, rng = rng.next01()
    wide_a, rng = rng.next01()
    z = wide_z * 2.0 - 1.0
    a = wide_a * TWO_PI
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return Vec3(r * torch.cos(a), r * torch.sin(a), z), rng


def random_unit_vector_normalized3(rng):
    u, rng = rng.next01()
    v, rng = rng.next01()
    w, rng = rng.next01()
    u = 2.0 * u - 1.0
    v = 2.0 * v - 1.0
    w = 2.0 * w - 1.0
    d2 = u * u + v * v + w * w
    inv = 1.0 / torch.sqrt(torch.clamp(d2, min=1e-20))
    return Vec3(u * inv, v * inv, w * inv), rng


def unit_vector_sampler(name: str):
    """The sampler a config's ``unit_vector_sampler`` names."""
    if name == "zangle":
        return random_unit_vector_zangle
    return random_unit_vector_normalized3
