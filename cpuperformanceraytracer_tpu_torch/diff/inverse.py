"""Inverse rendering: recover scene parameters from a target image by
pixel-gradient descent.

Counterpart of ``cpuperformanceraytracer_tpu.diff.inverse``: Adam over a
parameter dict (``torch.optim.Adam``, which adds ``eps`` outside the
square root of the bias-corrected second moment, as optax's ``adam``
does); each step renders, takes the L2 pixel gradient and updates the
parameters in place. The K-steps-per-dispatch fusion of the JAX version
is a workaround for the TPU backend's dispatch cost and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from cpuperformanceraytracer_tpu_torch.diff.grad import image_loss, render_for_params


@dataclasses.dataclass
class InverseProblem:
    scene: object
    camera: object
    texture: object
    cfg: object
    target: torch.Tensor


def make_train_step(problem: InverseProblem, optimizer,
                    resample_frames: bool = False) -> Callable:
    """``(params, step) -> loss``: one optimizer step over ``params``, the
    dict of leaf tensors ``optimizer`` updates in place.

    resample_frames=False keeps one fixed sample set (frame 0): the loss
    is deterministic in the params and descent converges fast (the target
    must be rendered with the same cfg and frame). True draws a fresh
    sample set per step: unbiased stochastic gradients over path space.
    """

    def train_step(params: Dict, step: int) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        img = render_for_params(params, problem.scene, problem.camera,
                                problem.texture, problem.cfg,
                                step if resample_frames else 0)
        loss = image_loss(img, problem.target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def adam_inverse_render(problem: InverseProblem, init_params: Dict,
                        steps: int = 200, learning_rate: float = 0.01,
                        resample_frames: bool = False,
                        log_every: int = 0, logger=None,
                        eps: float = 1e-8) -> tuple:
    """Run Adam; returns (final_params, losses).

    With ``log_every`` and a ``logger``, steps 0, log_every, 2 * log_every,
    ... log ``inverse step %d loss %.6f`` at INFO (the JAX package's steps
    and message).

    ``eps`` is Adam's denominator epsilon, usable as a gradient noise
    floor: ~1e-2 damps the tiny cross-talk gradients of barely observed
    parameters (geometry recovery); 1e-8 suits smooth, well-observed
    parameters such as albedo and emissive.
    """
    params = {k: v.detach().clone().requires_grad_()
              for k, v in init_params.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate,
                                 eps=eps)
    train_step = make_train_step(problem, optimizer, resample_frames)
    losses: List[torch.Tensor] = []
    for i in range(steps):
        losses.append(train_step(params, i))
        if log_every and logger and i % log_every == 0:
            logger.info("inverse step %d loss %.6f", i, float(losses[-1]))
    return ({k: v.detach() for k, v in params.items()},
            [float(x) for x in losses])
