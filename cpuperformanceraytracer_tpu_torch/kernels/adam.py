"""Adam's update of every trained leaf in one kernel, and its plain
version.

Replaces no Pallas kernel: the JAX package's update is ``optax.adam``,
which XLA fuses inside the training step's ``lax.scan``. On the card the
port's step ran ``torch.optim.Adam(capturable=True)``, torch's foreach
chain of about 17 kernels a step. ``csrc/adam.cu`` does the same float32
arithmetic in one launch over every leaf (and a tiny one that advances
the step tensors first), so its parameters and state are bit-equal to
torch's. It is bound by bytes, 28 an element (p, g, m and v read; p, m
and v written); the source says what its design does about that.

``adam_reference`` is the plain version, the kernel's arithmetic line by
line in torch ops, each rounding as that op rounds: it can differ from
the kernel in the last bit where the kernel fuses a multiply-add as
torch's foreach kernels do. ``adam`` is the wrapper: CPU tensors take the plain
version, CUDA tensors launch the kernel (counted through
``profiling.count_launch``); any other device raises. ``adam_step`` is
one step of a ``torch.optim.Adam`` through ``adam``, on the optimizer's
own state, which it creates as ``torch.optim.Adam`` does; it raises for
an option the kernel does not implement, and nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library
from cpuperformanceraytracer_tpu_torch.utils.profiling import count_launch

# leaves a launch takes: the table csrc/adam.cu passes by value
MAX_LEAVES = 32


def adam_reference(params, grads, exp_avgs, exp_avg_sqs, steps, *, lr: float,
                   beta1: float, beta2: float, eps: float,
                   weight_decay: float = 0.0, maximize: bool = False) -> None:
    """Plain-torch Adam step, in place: the step tensors, ``exp_avgs``,
    ``exp_avg_sqs`` and ``params`` (lists of tensors, a leaf each)."""
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        step.add_(1)
        if maximize:
            g = -g
        if weight_decay != 0:
            g = g.add(p, alpha=weight_decay)
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2)
        v.add_((1 - beta2) * (g * g))
        # torch's foreach ops divide by a python scalar as a multiply by
        # its reciprocal, taken in double
        step_size = 1 / ((torch.pow(beta1, step) - 1) * (1 / lr))
        bc2 = torch.sqrt(-(torch.pow(beta2, step) - 1))
        d = (torch.sqrt(v) / bc2 + eps) / step_size
        p.add_(m / d)


def _check_cuda(leaves, device):
    bad = []
    for i, (p, g, m, v, step) in enumerate(leaves):
        for name, t in (("param", p), ("grad", g), ("exp_avg", m),
                        ("exp_avg_sq", v)):
            if (t.device != device or t.shape != p.shape
                    or t.dtype != torch.float32 or not t.is_contiguous()):
                bad.append(f"leaf {i} {name} {tuple(t.shape)} {t.dtype} "
                           f"{t.device}")
        if step.device != device or step.dtype != torch.float32 \
                or step.dim() != 0:
            bad.append(f"leaf {i} step {tuple(step.shape)} {step.dtype} "
                       f"{step.device}")
    if len(leaves) > MAX_LEAVES:
        bad.append(f"{len(leaves)} leaves (a launch takes {MAX_LEAVES})")
    if bad:
        raise ValueError("adam: " + "; ".join(bad))


def adam(params, grads, exp_avgs, exp_avg_sqs, steps, *, lr: float,
         beta1: float, beta2: float, eps: float, weight_decay: float = 0.0,
         maximize: bool = False) -> None:
    """Adam wrapper: one step over the leaves, in place (see
    ``adam_reference``)."""
    leaves = list(zip(params, grads, exp_avgs, exp_avg_sqs, steps))
    if not leaves:
        return
    device = leaves[0][0].device
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, maximize=maximize)
    if device.type == "cpu":
        adam_reference(params, grads, exp_avgs, exp_avg_sqs, steps, **hyper)
        return
    if device.type != "cuda":
        raise ValueError(f"adam: unsupported device {device}")
    _check_cuda(leaves, device)
    table = (ctypes.c_longlong * (6 * len(leaves)))(*(
        x for p, g, m, v, step in leaves
        for x in (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                  step.data_ptr(), p.numel())))
    # 1 / lr, 1 - beta1 and 1 - beta2 in double, rounded to float as
    # torch's foreach ops round their python scalars
    check(load_library().cprt_adam(
        table, len(leaves), 1 / lr, beta1, beta2, 1 - beta1, 1 - beta2, eps,
        weight_decay, int(maximize),
        torch.cuda.current_stream(device).cuda_stream), "adam")
    count_launch(adam)


adam.launches = 0


def _options(group: dict) -> None:
    """Raise for what the kernel does not implement."""
    bad = [name for name in ("amsgrad", "differentiable", "fused",
                             "decoupled_weight_decay") if group.get(name)]
    bad += [name for name in ("lr", "betas")
            if isinstance(group[name], torch.Tensor)
            or (name == "betas"
                and any(isinstance(b, torch.Tensor) for b in group[name]))]
    if bad:
        raise ValueError(f"adam_step: the kernel does not implement "
                         f"{', '.join(bad)}")


def adam_step(optimizer: torch.optim.Adam) -> None:
    """One step of ``optimizer``, a ``torch.optim.Adam``, through ``adam``:
    each param group's leaves with a gradient in one call, on
    ``optimizer.state[p]`` (``step``, ``exp_avg``, ``exp_avg_sq``, made at
    the first step as ``torch.optim.Adam`` makes them and updated in
    place). A leaf whose ``.grad`` is None is skipped. Raises
    ``ValueError`` for amsgrad, differentiable, fused, decoupled weight
    decay, a tensor lr or tensor betas, a leaf or gradient that is not
    float32, and, on the card, a step tensor off the leaf's device (an
    optimizer built without ``capturable=True``)."""
    for group in optimizer.param_groups:
        _options(group)
        leaves = [p for p in group["params"] if p.grad is not None]
        if not group["capturable"] and any(p.is_cuda for p in leaves):
            raise ValueError("adam_step: CUDA leaves need capturable=True "
                             "(the kernel reads the step on the card)")
        for p in leaves:
            if p.dtype != torch.float32 or p.grad.dtype != torch.float32 \
                    or p.grad.is_sparse:
                raise ValueError(f"adam_step: a {p.dtype} leaf with a "
                                 f"{p.grad.dtype} gradient (the kernel takes "
                                 f"float32)")
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if group["capturable"] else None)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
        if not leaves:
            continue
        states = [optimizer.state[p] for p in leaves]
        beta1, beta2 = group["betas"]
        with torch.no_grad():
            adam([p.detach() for p in leaves],
                 [p.grad for p in leaves],
                 [s["exp_avg"] for s in states],
                 [s["exp_avg_sq"] for s in states],
                 [s["step"] for s in states],
                 lr=group["lr"], beta1=beta1, beta2=beta2, eps=group["eps"],
                 weight_decay=group["weight_decay"],
                 maximize=group["maximize"])
