"""Pinhole camera: image plane at distance 1/tan(FOV/2), looking down
+z (``forward_z=1``) or -z (``forward_z=-1``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3


class Camera(NamedTuple):
    position: Vec3          # three f32 0-d tensors
    distance: torch.Tensor  # f32 0-d
    forward_z: torch.Tensor  # f32 0-d, +1 or -1


def make_camera(position=(0.0, 0.0, 0.0), fov_degrees: float = 90.0,
                forward_z: float = 1.0, device="cpu") -> Camera:
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    dist = 1.0 / math.tan(math.radians(fov_degrees) * 0.5)
    return Camera(position=Vec3(*(f32(p) for p in position)),
                  distance=f32(dist), forward_z=f32(forward_z))
