"""Named scene presets, identical to the JAX package's:

- ``cornell_box``: the scalar renderer's box, three diffuse spheres,
  camera at the origin looking +z.
- ``glass_spheres``: the v4 hero scene, seven refractive spheres with a
  0..0.5 roughness ramp; the striped background quad is added WITHOUT
  the scene translation, as the reference builds it.

Both return (Scene, Camera) with tensors on ``device``.
"""

from __future__ import annotations

from typing import Tuple

from cpuperformanceraytracer_tpu_torch.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu_torch.scene.camera import Camera, make_camera
from cpuperformanceraytracer_tpu_torch.scene.types import Material, Scene


def cornell_box_scene(device="cpu") -> Tuple[Scene, Camera]:
    b = SceneBuilder(translation=(0.0, 0.0, 10.0))
    grey = b.add_material(Material(albedo=(0.7, 0.7, 0.7)))
    red = b.add_material(Material(albedo=(0.7, 0.1, 0.1)))
    green = b.add_material(Material(albedo=(0.1, 0.7, 0.1)))
    light = b.add_material(Material(emissive=(20.0, 18.0, 14.0)))
    s1 = b.add_material(Material(albedo=(0.9, 0.9, 0.75)))
    s2 = b.add_material(Material(albedo=(0.9, 0.75, 0.9)))
    s3 = b.add_material(Material(albedo=(0.75, 0.9, 0.9)))

    b.add_quad((-12.6, -12.6, 25.0), (12.6, -12.6, 25.0),
               (12.6, 12.6, 25.0), (-12.6, 12.6, 25.0), grey)     # back
    b.add_quad((-12.6, -12.45, 25.0), (12.6, -12.45, 25.0),
               (12.6, -12.45, 15.0), (-12.6, -12.45, 15.0), grey)  # floor
    b.add_quad((-12.6, 12.5, 25.0), (12.6, 12.5, 25.0),
               (12.6, 12.5, 15.0), (-12.6, 12.5, 15.0), grey)     # ceiling
    b.add_quad((-12.5, -12.6, 25.0), (-12.5, -12.6, 15.0),
               (-12.5, 12.6, 15.0), (-12.5, 12.6, 25.0), red)     # left
    b.add_quad((12.5, -12.6, 25.0), (12.5, -12.6, 15.0),
               (12.5, 12.6, 15.0), (12.5, 12.6, 25.0), green)     # right
    b.add_quad((-5.0, 12.4, 22.5), (5.0, 12.4, 22.5),
               (5.0, 12.4, 17.5), (-5.0, 12.4, 17.5), light)      # light

    b.add_sphere((-9.0, -9.5, 20.0), 3.0, s1)
    b.add_sphere((0.0, -9.5, 20.0), 3.0, s2)
    b.add_sphere((9.0, -9.5, 20.0), 3.0, s3)

    camera = make_camera((0.0, 0.0, 0.0), 90.0, 1.0, device=device)
    return b.build(device), camera


def glass_spheres_scene(grey_albedo_bug: bool = False,
                        device="cpu") -> Tuple[Scene, Camera]:
    b = SceneBuilder(translation=(0.0, 0.0, 10.0),
                     grey_albedo_bug=grey_albedo_bug)

    floor = b.add_material(Material(albedo=(0.7, 0.7, 0.7)))
    b.add_quad((-25.0, -12.5, 5.0), (25.0, -12.5, 5.0),
               (25.0, -12.5, -5.0), (-25.0, -12.5, -5.0), floor)

    stripes = b.add_material(Material(albedo=(0.35, 0.35, 0.35)))
    b.add_quad((-25.0, -1.5, 5.0), (25.0, -1.5, 5.0),
               (25.0, -10.5, 5.0), (-25.0, -10.5, 5.0), stripes,
               translate=False)  # the reference builds this one untranslated

    ceiling = b.add_material(Material(albedo=(0.7, 0.7, 0.7)))
    b.add_quad((-7.5, 12.5, 5.0), (7.5, 12.5, 5.0),
               (7.5, 12.5, -5.0), (-7.5, 12.5, -5.0), ceiling)

    light = b.add_material(Material(emissive=(20.0, 18.0, 14.0)))
    b.add_quad((-5.0, 12.4, 2.5), (5.0, 12.4, 2.5),
               (5.0, 12.4, -2.5), (-5.0, 12.4, -2.5), light)

    n_spheres = 7
    for i in range(n_spheres):
        r = (i / (n_spheres - 1)) * 0.5
        mat = b.add_material(Material(
            albedo=(0.9, 0.25, 0.25), specular_chance=0.02,
            specular_roughness=r, specular_color=(0.8, 0.8, 0.8), ior=1.1,
            refraction_chance=1.0, refraction_roughness=r,
            refraction_color=(0.0, 0.5, 1.0)))
        b.add_sphere((-18.0 + 6.0 * i, -8.0, 0.0), 2.8, mat)

    camera = make_camera((0.0, 0.0, 40.0), 90.0, -1.0, device=device)
    return b.build(device), camera


_PRESETS = {
    "cornell_box": cornell_box_scene,
    "glass_spheres": glass_spheres_scene,
}


def scene_by_name(name: str, **kwargs) -> Tuple[Scene, Camera]:
    try:
        make = _PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown scene {name!r}; have {sorted(_PRESETS)}") from None
    return make(**kwargs)
