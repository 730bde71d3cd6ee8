"""Parallel layer: a world of processes over ``torch.distributed``,
sharding the frame and the training step by pixel rows and samples.

Counterpart of ``cpuperformanceraytracer_tpu.parallel`` (the JAX
package's replacement for the reference's work queue): static sharding,
no queue, every pixel-row shard costing the same by construction, and
collectives (``all_reduce``) in place of the interlocked completion
counter.

Mesh axes:
  "px"  — pixel rows: rank (p, s) renders rows [p * H/n_px, (p + 1) *
          H/n_px) through kernel A's row window;
  "spp" — samples: each rank of a column renders a slice of the counter
          RNG's samples, summed by ``all_reduce`` over the column.
"""

from cpuperformanceraytracer_tpu_torch.parallel.mesh import (  # noqa: F401
    default_mesh,
    make_mesh,
)
from cpuperformanceraytracer_tpu_torch.parallel.shard import (  # noqa: F401
    make_sharded_frame_fn,
    sharded_render_frame,
)
