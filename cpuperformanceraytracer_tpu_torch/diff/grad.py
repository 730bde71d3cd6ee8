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
and run one dispatch per sample. Images are (3, H, W) tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.kernels.backward import render_frame_diff
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
    env_color_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    pack_camera,
    pack_scene,
    render_planes_reference,
)
from cpuperformanceraytracer_tpu_torch.scene.types import Scene
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture


def _vec3(v) -> Vec3:
    return Vec3(v[:, 0], v[:, 1], v[:, 2])


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
        e = params["env_rgb"]
        texture = texture._replace(r=e[:, 0], g=e[:, 1], b=e[:, 2])
    return scene, texture


def render_frame_plain(scene, camera, texture, cfg, frame: int,
                       spp_offset: int = 0) -> torch.Tensor:
    """The plain versions under autograd: (3, H, W) colour."""
    if cfg.rng != "counter":
        raise ValueError("the diff path requires rng='counter'")
    tables = (*pack_scene(scene), pack_camera(camera, cfg))
    one = cfg.replace(spp=1)
    acc = None
    for s in range(cfg.spp):
        planes = render_planes_reference(tables, one, frame, spp_offset + s)
        color, _ = env_color_reference(planes, texture, one)
        acc = color if acc is None else acc + color
    return acc * (1.0 / cfg.spp)


def render_for_params(params: Dict, scene: Scene, camera, texture, cfg,
                      frame: int = 0) -> torch.Tensor:
    scene, texture = apply_params(scene, texture, params)
    if cfg.backend == "cuda":
        return render_frame_diff(scene, camera, texture, cfg, frame)
    return render_frame_plain(scene, camera, texture, cfg.validate(), frame)


def image_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all pixels and channels."""
    return (torch.mean((a[0] - b[0]) ** 2) + torch.mean((a[1] - b[1]) ** 2)
            + torch.mean((a[2] - b[2]) ** 2)) / 3.0


def loss_and_grad(params: Dict, target: torch.Tensor, scene: Scene, camera,
                  texture, cfg, frame: int = 0):
    """(loss, grads) for the L2 pixel loss at the given params."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = image_loss(render_for_params(leaves, scene, camera, texture, cfg,
                                        frame), target)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}
