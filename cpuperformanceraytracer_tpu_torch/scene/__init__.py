"""Scene containers, builder, camera and named presets: the names
``cpuperformanceraytracer_tpu.scene`` exports."""

from cpuperformanceraytracer_tpu_torch.scene.types import (  # noqa: F401
    Material,
    Quads,
    Spheres,
    Materials,
    Scene,
    precompute_quads,
)
from cpuperformanceraytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
from cpuperformanceraytracer_tpu_torch.scene.camera import Camera, make_camera  # noqa: F401
from cpuperformanceraytracer_tpu_torch.scene.presets import (  # noqa: F401
    cornell_box_scene,
    glass_spheres_scene,
    scene_by_name,
)
