"""Differentiable rendering: parameters onto a scene, the L2 pixel loss
and its gradients (``grad``), the timed fwd+bwd step (``benchgrad``),
Adam inverse rendering (``inverse``) and the fixed-order segment sum
(``segsum``): the names ``cpuperformanceraytracer_tpu.diff`` exports."""

from cpuperformanceraytracer_tpu_torch.diff.grad import (  # noqa: F401
    render_for_params,
    image_loss,
    loss_and_grad,
)
from cpuperformanceraytracer_tpu_torch.diff.inverse import (  # noqa: F401
    InverseProblem,
    adam_inverse_render,
)
from cpuperformanceraytracer_tpu_torch.diff.segsum import (  # noqa: F401
    segment_sum_sorted,
)
