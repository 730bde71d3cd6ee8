"""Hand-written CUDA kernels and their plain versions: ``megakernel``
(kernel A, the forward), ``env_accumulate`` (kernel B, the env resolve),
``backward`` (kernel C, the path-replay adjoint, and the differentiable
sample), ``env_backward`` (kernel D, the env cotangents and texel
scatter), ``env_gather`` (kernel E, the deferred env lookup of every
mode and the texel fetch), ``combine`` (kernel F, the multi-sample
combine and accumulate), ``tonemap`` (kernel G, the display transform),
``adam`` (Adam's update of every trained leaf in one launch); ``_build``
compiles ``csrc/*.cu`` and loads the library (at first use,
never at import)."""

from cpuperformanceraytracer_tpu_torch.kernels.combine import (  # noqa: F401
    combine_accumulate,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_gather import (  # noqa: F401
    env_lookup,
    gather_texels,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (  # noqa: F401
    render_planes,
)
from cpuperformanceraytracer_tpu_torch.kernels.tonemap import (  # noqa: F401
    tonemap,
)
