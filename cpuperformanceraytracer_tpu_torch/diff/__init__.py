"""Differentiable rendering: parameters onto a scene, the L2 pixel loss
and its gradients (``grad``), the timed fwd+bwd step (``benchgrad``) and
Adam inverse rendering (``inverse``)."""
