"""Convert the JAX package's scene, camera and texture to the port's.

The inputs are duck-typed: any object (or dict) with the JAX field names
whose leaves convert with ``numpy.asarray`` (numpy arrays, Python
numbers, or the JAX package's own arrays). Nothing here imports jax.
Tests use it so that both packages render the identical scene.
"""

from __future__ import annotations

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.scene.camera import Camera
from cpuperformanceraytracer_tpu_torch.scene.types import (
    Materials,
    Quads,
    Scene,
    Spheres,
)
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def _f32(obj, name, device):
    return _tensor(_get(obj, name), np.float32, device)


def _vec3(obj, name, device) -> Vec3:
    v = _get(obj, name)
    return Vec3(*(_f32(v, c, device) for c in "xyz"))


def scene_from(scene, device="cpu") -> Scene:
    q = _get(scene, "quads")
    s = _get(scene, "spheres")
    m = _get(scene, "materials")
    quads = Quads(*(_vec3(q, f"v{i}", device) for i in range(4)),
                  material=_tensor(_get(q, "material"), np.int64, device))
    spheres = Spheres(center=_vec3(s, "center", device),
                      radius=_f32(s, "radius", device),
                      material=_tensor(_get(s, "material"), np.int64, device))
    fields = {}
    for name in Materials._fields:
        if name.endswith(("albedo", "emissive", "color")):
            fields[name] = _vec3(m, name, device)
        else:
            fields[name] = _f32(m, name, device)
    return Scene(quads, spheres, Materials(**fields))


def camera_from(camera, device="cpu") -> Camera:
    return Camera(position=_vec3(camera, "position", device),
                  distance=_f32(camera, "distance", device),
                  forward_z=_f32(camera, "forward_z", device))


def texture_from(texture, device="cpu") -> Texture:
    return Texture(*(_f32(texture, c, device).reshape(-1).contiguous()
                     for c in "rgb"),
                   int(_get(texture, "width")), int(_get(texture, "height")))
