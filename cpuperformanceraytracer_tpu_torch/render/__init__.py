"""Oracle integrator, frame step (kernel A -> kernel B, A -> E -> F, or
the oracle) and the OfflineRenderer: the names
``cpuperformanceraytracer_tpu.render`` exports."""

from cpuperformanceraytracer_tpu_torch.render.integrator import (  # noqa: F401
    Hit,
    MaterialSample,
    trace_scene,
    color_for_ray,
    camera_ray,
    render_pixel,
)
from cpuperformanceraytracer_tpu_torch.render.frame import (  # noqa: F401
    render_frame,
    accumulate_frame,
    postprocess_image,
    make_frame_fn,
)
from cpuperformanceraytracer_tpu_torch.render.driver import (  # noqa: F401
    RenderState,
    OfflineRenderer,
)
