"""Vec2/Vec3 math, hash RNGs, unit-vector samplers, color transforms:
the names ``cpuperformanceraytracer_tpu.core`` exports."""

from cpuperformanceraytracer_tpu_torch.core.vecmath import (  # noqa: F401
    Vec2,
    Vec3,
    vec2,
    vec3,
    dot2,
    dot3,
    cross,
    length,
    normalize,
    reflect,
    refract,
    lerp,
    lerp3,
    saturate,
    saturate3,
    fresnel_reflect_amount,
)
from cpuperformanceraytracer_tpu_torch.core.rng import (  # noqa: F401
    wang_hash,
    rand01,
    signed_rand01,
    pixel_seed,
    counter_rand01,
    CounterRng,
    WangRng,
)
from cpuperformanceraytracer_tpu_torch.core.color import (  # noqa: F401
    aces_film,
    linear_to_srgb,
    srgb_to_linear,
    postprocess_color,
)
from cpuperformanceraytracer_tpu_torch.core.sampling import (  # noqa: F401
    random_unit_vector_zangle,
    random_unit_vector_normalized3,
)
