"""Env texture, equirect and cubemap samplers, RGBE codec, procedural
sky: the names ``cpuperformanceraytracer_tpu.texture`` exports (a
sampler's ``Vec2 uv`` is two tensors ``u, v`` here)."""

from cpuperformanceraytracer_tpu_torch.texture.hdr import (  # noqa: F401
    read_hdr,
    write_hdr,
)
from cpuperformanceraytracer_tpu_torch.texture.texture import (  # noqa: F401
    Texture,
    texture_from_array,
    load_texture,
    load_cubemap_texture,
    texel_fetch,
    sample_bilinear,
    sample_nearest,
    sample_stochastic,
    equirect_uv,
    sample_equirect,
    cubemap_uv,
    sample_cubemap,
    sample_environment,
)
from cpuperformanceraytracer_tpu_torch.texture.procedural import (  # noqa: F401
    gradient_sky,
)
