"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

The same inputs, made from a seed with numpy, go through the JAX
package (on the CPU, as conftest.py sets it up) and through the port;
data crosses between the two as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# six xdist workers share the machine: one intra-op thread each
torch.set_num_threads(1)

# what ``utils/profiling.read()`` gives with nothing recorded
NOTHING_TRACED = {"lanes": {}, "phases_ms": {}}


@pytest.fixture
def cuda_device():
    """The GPU, or a skip: CUDA tests need a card (marker ``cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def jax_cfg(**kw):
    """A JAX-package RenderConfig on the Pallas megakernel path at a
    test size (8x128 blocks)."""
    from cpuperformanceraytracer_tpu.config import RenderConfig

    base = dict(width=128, height=16, spp=1, backend="pallas",
                tile_height=8, tile_width=128, num_frames=3,
                warmup_frames=0)
    base.update(kw)
    return RenderConfig(**base)


def port_cfg(jcfg, **kw):
    """The port's RenderConfig with every field the two share, on the
    plain-torch backend (the CPU tests ask for it explicitly)."""
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig

    names = {f.name for f in dataclasses.fields(RenderConfig)} - {"backend"}
    shared = {n: getattr(jcfg, n) for n in names}
    shared["backend"] = "torch"
    shared.update(kw)
    return RenderConfig(**shared)


def port_scene(jax_scene, jax_camera, device="cpu"):
    """The JAX scene and camera, converted to the port's objects."""
    from cpuperformanceraytracer_tpu_torch.io.convert import (
        camera_from,
        scene_from,
    )

    return scene_from(jax_scene, device), camera_from(jax_camera, device)


def assert_robust(a, b, rel_mean=1e-2, frac=0.02, what=""):
    """Glass/lottery parity (tests/test_pallas.py policy): a 1-ulp
    transcendental difference may flip one path, so per channel the
    means agree to ``rel_mean`` and under ``frac`` of pixels differ by
    more than 1e-3."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert abs(a.mean() - b.mean()) < rel_mean * max(abs(a.mean()), 1e-3), (
        f"{what}: means {a.mean():.6g} vs {b.mean():.6g}")
    off = np.mean(np.abs(a - b) > 1e-3)
    assert off < frac, f"{what}: {off:.4%} of pixels differ by > 1e-3"


def beer_scene(builder, material, make_camera, **device):
    """The decision-stable scene with a geometry gradient, built by either
    package's ``SceneBuilder`` (``device=`` for the port's): the grey
    floor quad and one glass sphere that every path refracts through
    (refraction chance 1, no specular), so Beer absorption carries the
    sphere and camera gradients and no lottery decision can flip."""
    b = builder(translation=(0.0, 0.0, 10.0))
    grey = b.add_material(material(albedo=(0.6, 0.55, 0.5)))
    glass = b.add_material(material(
        albedo=(0.9, 0.9, 0.9), specular_chance=0.0, refraction_chance=1.0,
        ior=1.5, refraction_color=(0.5, 0.2, 0.1)))
    b.add_quad((-25.0, -12.45, 15.0), (25.0, -12.45, 15.0),
               (25.0, -12.45, -15.0), (-25.0, -12.45, -15.0), grey)
    b.add_sphere((0.0, -2.0, 0.0), 6.0, glass)
    cam = make_camera(position=(0.0, 0.0, 40.0), fov_degrees=90.0,
                      forward_z=-1.0, **device)
    return b.build(**device), cam


def port_beer_scene(device="cpu"):
    from cpuperformanceraytracer_tpu_torch.scene.builder import SceneBuilder
    from cpuperformanceraytracer_tpu_torch.scene.camera import make_camera
    from cpuperformanceraytracer_tpu_torch.scene.types import Material

    return beer_scene(SceneBuilder, Material, make_camera, device=device)


def kernel_d_order(g, idx, mt, n_tex):
    """Kernel D's texel sums in its own order, in plain torch on the CPU:
    per chunk of 32 neighbouring pixels, each run of equal texels summed
    by the kernel's segmented scan (5 shuffle steps, ``up + x``), the runs
    with three zero sums dropped, the others as records in slot order, a
    stable sort by texel, and each texel's records added in sorted order to
    +0.0. Returns the three (n_tex,) planes."""
    key = idx.reshape(-1).cpu()
    v = (g * mt).reshape(3, -1).cpu()
    n = key.numel()
    m = (n + 31) // 32 * 32
    key = torch.cat([key, torch.full((m - n,), -1, dtype=key.dtype)]).view(-1, 32)
    v = torch.cat([v, torch.zeros((3, m - n))], 1).view(3, -1, 32)
    lane = torch.arange(32)
    head = torch.ones_like(key, dtype=torch.bool)
    head[:, 1:] = key[:, 1:] != key[:, :-1]
    start = torch.where(head, lane, torch.zeros_like(lane)).cummax(1).values
    x = v.clone()
    for d in (1, 2, 4, 8, 16):
        up = torch.zeros_like(x)
        up[..., d:] = x[..., :-d]
        x = torch.where(lane - d >= start, up + x, x)
    last = torch.ones_like(head)
    last[:, :-1] = key[:, :-1] != key[:, 1:]
    keep = (last & (key >= 0) & (x != 0).any(0)).reshape(-1)
    keys = torch.where(keep, key.reshape(-1), torch.full_like(keep, n_tex,
                                                             dtype=key.dtype))
    order = torch.sort(keys, stable=True).indices
    rec = keep[order].nonzero().squeeze(1)
    slots = order[rec]
    # the CPU's index_add_ adds in index order: each texel from +0.0 on
    return tuple(torch.zeros(n_tex).index_add_(0, keys[slots], x[c].reshape(-1)[slots])
                 for c in range(3))
