"""Inverse rendering: recover scene parameters from a target image by
pixel-gradient descent.

Counterpart of ``cpuperformanceraytracer_tpu.diff.inverse``: Adam over a
parameter dict (``torch.optim.Adam``, which adds ``eps`` outside the
square root of the bias-corrected second moment, as optax's ``adam``
does); each step renders, takes the L2 pixel gradient and updates the
parameters in place. ``make_train_step_k`` runs K steps in one dispatch,
as the JAX ``lax.scan``: on the card one CUDA graph of the K steps and
their Adam updates (``capturable=True``), on the CPU a loop. On the card
(``backend == "cuda"``) a ``torch.optim.Adam``'s update is one
hand-written kernel (``kernels/adam.adam_step``), bit-equal to torch's
capturable step; on the CPU, on the plain route (``backend == "torch"``)
and for any other optimizer, it is ``optimizer.step()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from cpuperformanceraytracer_tpu_torch.diff.graph import StepGraph
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    fixed_quad_table,
    image_loss,
    render_for_params,
)
from cpuperformanceraytracer_tpu_torch.kernels.adam import adam_step
from cpuperformanceraytracer_tpu_torch.utils import profiling


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
    dict of leaf tensors ``optimizer`` updates in place; ``step`` is an
    int or a ``DeviceFrame``.

    resample_frames=False keeps one fixed sample set (frame 0): the loss
    is deterministic in the params and descent converges fast (the target
    must be rendered with the same cfg and frame). True draws a fresh
    sample set per step: unbiased stochastic gradients over path space.
    The scene's quad table is derived once, here.

    With tracing on, a step is four phases (``utils/profiling.phases``):
    ``step.render`` (the gradients' reset, the parameters' packing,
    kernels A and B), ``step.loss``, ``step.backward`` (the loss's
    backward, kernels C and D and their glue) and ``step.adam`` (with
    ``backend == "cuda"``, a ``torch.optim.Adam`` over CUDA leaves steps
    through the kernel of ``kernels/adam.py``, which raises for what it
    does not implement, ``capturable=False`` among it; otherwise, as on
    the plain route, ``optimizer.step()``).
    """
    quad_tbl = fixed_quad_table(problem.scene)
    device = problem.target.device
    leaf = optimizer.param_groups[0]["params"][0]
    adam_kernel = (type(optimizer) is torch.optim.Adam and leaf.is_cuda
                   and problem.cfg.backend == "cuda")

    def train_step(params: Dict, step) -> torch.Tensor:
        steps = profiling.phases(device)
        with steps.phase("step.render"):
            optimizer.zero_grad(set_to_none=True)
            img = render_for_params(params, problem.scene, problem.camera,
                                    problem.texture, problem.cfg,
                                    step if resample_frames else 0, quad_tbl)
        with steps.phase("step.loss"):
            loss = image_loss(img, problem.target)
        with steps.phase("step.backward"):
            loss.backward()
        with steps.phase("step.adam"):
            if adam_kernel:
                adam_step(optimizer)
            else:
                optimizer.step()
        return loss.detach()

    return train_step


def make_train_step_k(problem: InverseProblem, optimizer, k: int,
                      resample_frames: bool = False) -> Callable:
    """``(params, step0) -> losses``: K optimizer steps (steps step0 ...
    step0 + k - 1) in one dispatch; ``losses`` is a (k,) tensor.

    On the CPU the K steps run in a loop. On the card the first call
    captures them, with their updates, into one CUDA graph
    (``diff/graph.StepGraph``), and every call replays it with ``step0``;
    ``optimizer`` must be ``capturable`` and ``params`` the tensors it
    updates. The capture's warm-up steps on a side stream are undone:
    the parameters and the optimizer's state are put back as they were
    before them. With tracing on, a call on the card is the span
    ``dispatch``, with the children ``dispatch.replay`` and
    ``dispatch.losses``."""
    train_step = make_train_step(problem, optimizer, resample_frames)
    graph = captured = None

    def k_steps(params, frames):
        return torch.stack([train_step(params, f) for f in frames])

    def train_step_k(params: Dict, step0: int) -> torch.Tensor:
        device = next(iter(params.values())).device
        if device.type != "cuda":
            return k_steps(params, [int(step0) + i for i in range(k)])
        with profiling.span("dispatch"):
            return dispatch(params, step0, device)

    def dispatch(params: Dict, step0: int, device) -> torch.Tensor:
        nonlocal graph, captured
        if graph is None:
            if not all(g.get("capturable") for g in optimizer.param_groups):
                raise ValueError("make_train_step_k on the card needs a "
                                 "capturable optimizer (capturable=True)")
            saved = {p: (p.detach().clone(),
                         {n: v.clone() for n, v in optimizer.state[p].items()})
                     for p in params.values()}
            graph = StepGraph(lambda frames: k_steps(params, frames), k,
                              device)
            with torch.no_grad():
                for p, (value, kept) in saved.items():
                    p.copy_(value)
                    for n, v in optimizer.state[p].items():
                        if n in kept:
                            v.copy_(kept[n])
                        else:  # a state the warm-up step created: fresh
                            v.zero_()
            captured = dict(params)
        if any(v is not captured.get(n) for n, v in params.items()):
            raise ValueError("make_train_step_k: params are not the tensors "
                             "the graph was captured with")
        with profiling.span("dispatch.replay"):
            losses = graph.replay(step0)
        with profiling.span("dispatch.losses"):
            return losses.clone()

    return train_step_k


def adam_inverse_render(problem: InverseProblem, init_params: Dict,
                        steps: int = 200, learning_rate: float = 0.01,
                        resample_frames: bool = False,
                        log_every: int = 0, logger=None,
                        eps: float = 1e-8,
                        steps_per_dispatch: int = 0) -> tuple:
    """Run Adam; returns (final_params, losses).

    With ``log_every`` and a ``logger``, steps 0, log_every, 2 * log_every,
    ... log ``inverse step %d loss %.6f`` at INFO (the JAX package's steps
    and message).

    ``eps`` is Adam's denominator epsilon, usable as a gradient noise
    floor: ~1e-2 damps the tiny cross-talk gradients of barely observed
    parameters (geometry recovery); 1e-8 suits smooth, well-observed
    parameters such as albedo and emissive.

    ``steps_per_dispatch``: K optimizer steps per dispatch
    (``make_train_step_k``; a last chunk of fewer steps gets its own); 0
    picks JAX's rule, the logging cadence when logging, else
    min(steps, 16); 1 is the per-step loop. On the card Adam is
    ``capturable`` whatever K is, so every K takes the same arithmetic.
    """
    params = {k: v.detach().clone().requires_grad_()
              for k, v in init_params.items()}
    device = next(iter(params.values())).device
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate,
                                 eps=eps, capturable=device.type == "cuda")
    k = steps_per_dispatch
    if not k:
        k = log_every if (log_every and logger) else min(steps, 16)
    k = max(1, min(k, steps))

    losses: List[torch.Tensor] = []
    if k == 1:
        train_step = make_train_step(problem, optimizer, resample_frames)
        for i in range(steps):
            losses.append(train_step(params, i))
            if log_every and logger and i % log_every == 0:
                logger.info("inverse step %d loss %.6f", i, float(losses[-1]))
    else:
        chunks = {}
        done = 0
        while done < steps:
            todo = min(k, steps - done)
            if todo not in chunks:
                chunks[todo] = make_train_step_k(problem, optimizer, todo,
                                                 resample_frames)
            chunk = chunks[todo](params, done)
            if log_every and logger:
                # the boundary step inside this chunk, if any, with its loss
                off = (-done) % log_every
                if off < todo:
                    logger.info("inverse step %d loss %.6f", done + off,
                                float(chunk[off]))
            losses.extend(chunk)
            done += todo
    return ({k: v.detach() for k, v in params.items()},
            [float(x) for x in losses])
