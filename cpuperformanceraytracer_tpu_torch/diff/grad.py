"""Differentiable render wrappers: apply a parameter dict to a scene,
render, and take pixel-loss gradients.

Counterpart of ``cpuperformanceraytracer_tpu.diff.grad``, with its
gradient policy:
  - material fields, emissive, env texels: exact chosen-branch path
    derivatives (the counter RNG replays the lottery identically);
  - lottery probabilities and Russian-roulette weights are detached
    (estimator weights, not physics);
  - geometry (sphere centers and radii, quad vertices): gradients flow
    through hit distances and normals, away from silhouette edges.

``render_for_params`` picks the implementation from ``cfg.backend``:
``"cuda"`` runs ``kernels.backward.render_frame_diff`` (kernels A to D),
``"torch"`` autograd through the plain kernel A and
``env_color_reference`` on the scene's device. Both need the counter RNG
and run one dispatch per sample. ``"oracle"`` is autograd through the
oracle integrator (``render/integrator.py``, the JAX ``"xla"`` route):
either RNG, every env sampling, bilinear included. The frame is an int
or a ``core.rng.DeviceFrame``. Images are (3, H, W) tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.kernels.backward import (
    render_frame_diff,
    require_diff_env,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
    env_color_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    pack_camera,
    pack_quads,
    pack_scene,
    render_planes_reference,
)
from cpuperformanceraytracer_tpu_torch.render.integrator import render_frame
from cpuperformanceraytracer_tpu_torch.scene.types import Scene
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture


def _vec3(v) -> Vec3:
    """An (N, 3) tensor's columns: one unbind, so the backward stacks the
    three column gradients in one kernel (three column selects would each
    zero an (N, 3) tensor and copy into it)."""
    return Vec3(*v.unbind(-1))


def apply_params(scene: Scene, texture: Optional[Texture], params: Dict):
    """Overlay a params dict onto (scene, texture).

    Recognized keys (all optional):
      sphere_centers: (NS, 3)   sphere_radii: (NS,)
      quad_v0/v1/v2/v3: (NQ, 3)
      albedo / emissive / specular_color / refraction_color: (NM, 3)
      specular_chance/roughness, ior, refraction_chance/roughness: (NM,)
      env_rgb: (H*W, 3) flattened env-map texel planes
    """
    spheres = scene.spheres
    if "sphere_centers" in params:
        spheres = spheres._replace(center=_vec3(params["sphere_centers"]))
    if "sphere_radii" in params:
        spheres = spheres._replace(radius=params["sphere_radii"])

    quads = scene.quads
    for key in ("v0", "v1", "v2", "v3"):
        if f"quad_{key}" in params:
            quads = quads._replace(**{key: _vec3(params[f"quad_{key}"])})

    mats = scene.materials
    for name in ("albedo", "emissive", "specular_color", "refraction_color"):
        if name in params:
            mats = mats._replace(**{name: _vec3(params[name])})
    for name in ("specular_chance", "specular_roughness", "ior",
                 "refraction_chance", "refraction_roughness"):
        if name in params:
            mats = mats._replace(**{name: params[name]})

    scene = scene._replace(spheres=spheres, quads=quads, materials=mats)

    if "env_rgb" in params and texture is not None:
        # contiguous channel planes in one copy: the kernels take them as
        # they are, and the backward is one stack and one transpose
        r, g, b = params["env_rgb"].t().contiguous().unbind(0)
        texture = texture._replace(r=r, g=g, b=b)
    return scene, texture


def render_frame_plain(scene, camera, texture, cfg, frame,
                       spp_offset: int = 0, quad_tbl=None, row0: int = 0,
                       local_height=None) -> torch.Tensor:
    """The plain versions under autograd: (3, local_height, W) colour of
    global rows [row0, row0 + local_height) (the whole image by default);
    ``quad_tbl`` is the scene's quad table when the caller derived it."""
    if cfg.rng != "counter":
        raise ValueError("the diff path requires rng='counter'")
    require_diff_env(cfg)
    tables = (*pack_scene(scene, quad_tbl), pack_camera(camera, cfg))
    one = cfg.replace(spp=1)
    acc = None
    for s in range(cfg.spp):
        planes = render_planes_reference(tables, one, frame, spp_offset + s,
                                         row0=row0, local_height=local_height)
        color, _ = env_color_reference(planes, texture, one)
        acc = color if acc is None else acc + color
    return acc * (1.0 / cfg.spp)


def fixed_quad_table(scene: Scene) -> torch.Tensor:
    """The quad table of ``scene``'s own quads, for a loss built once and
    called every step: ``render_for_params`` takes it for params that
    move no quad, and derives the table anew for those that do."""
    with torch.no_grad():
        return pack_quads(scene.quads)


def render_for_params(params: Dict, scene: Scene, camera, texture, cfg,
                      frame=0, quad_tbl=None, spp_offset: int = 0,
                      row0: int = 0, local_height=None) -> torch.Tensor:
    """(3, H, W) colour of ``scene`` and ``texture`` with ``params``
    applied; ``quad_tbl`` is ``fixed_quad_table(scene)`` when the caller
    keeps one (the kernel routes). On the kernel routes ``spp_offset``,
    ``row0`` and ``local_height`` pick the samples and the pixel-row
    window (``cfg.spp`` samples from ``spp_offset``; (3, local_height, W)
    colour), as the JAX ``render_frame_pallas_diff``'s sharding hooks;
    the oracle renders the whole image."""
    if any(name.startswith("quad_") for name in params):
        quad_tbl = None
    scene, texture = apply_params(scene, texture, params)
    win = dict(spp_offset=spp_offset, quad_tbl=quad_tbl, row0=row0,
               local_height=local_height)
    if cfg.backend == "cuda":
        return render_frame_diff(scene, camera, texture, cfg, frame, **win)
    if cfg.backend == "oracle":
        if spp_offset or row0 or local_height not in (None, cfg.height):
            raise ValueError("the oracle renders the whole image from sample "
                             "0 (no row window or sample offset)")
        return render_frame(scene, camera, texture, cfg.validate(), frame)
    return render_frame_plain(scene, camera, texture, cfg.validate(), frame,
                              **win)


def image_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all pixels and channels."""
    return (torch.mean((a[0] - b[0]) ** 2) + torch.mean((a[1] - b[1]) ** 2)
            + torch.mean((a[2] - b[2]) ** 2)) / 3.0


def value_and_grad(loss_fn, params: Dict, *args):
    """(loss, grads) of ``loss_fn(params, *args)``, a scalar, with respect
    to every tensor of the ``params`` dict (zeros where unused)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves, *args)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def loss_and_grad(params: Dict, target: torch.Tensor, scene: Scene, camera,
                  texture, cfg, frame=0):
    """(loss, grads) for the L2 pixel loss at the given params."""
    return value_and_grad(
        lambda p: image_loss(render_for_params(p, scene, camera, texture, cfg,
                                               frame), target), params)
