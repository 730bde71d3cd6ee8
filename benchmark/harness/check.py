"""The comparisons that decide ``correct``: what the window's calls
produced against the plain reference (``benchmark/reference/``) on the
same inputs. Each traffic kind (``benchmark/kinds/``) says what it
compares; the arithmetic is here.

A progressive frame: the reference renders the frame, accumulates it
into the program's accumulator from before it, and the two accumulators
after it are compared in colour units (their difference over the frame's
blend weight). A pixel is off when a channel differs by more than
``atol`` plus the float32 rounding of the accumulator scaled by 1 /
blend; the number compared is the largest share of pixels off over the
checked frames.

A training dispatch: the reference renders the target and follows the K
steps with autograd and Adam. Compared: the first step's loss (kernels A
and B, the target, the loss), and the worst gap, over the parameter
leaves, between the norms of the program's and the reference's change
over the K steps (kernels C and D through the trajectory, Adam). A leaf
whose first gradient in the reference (its root mean square) is under a
thousandth of the median leaf's moves by round-off alone and is left out
of the worst gap.
With K steps in one CUDA graph the optimizer's state between steps is
not observable; the later steps' losses swing with single bright paths
(fireflies) that one side's trajectory meets and the other's does not,
so they are logged, not compared (``PERF.md``).
"""

from __future__ import annotations

import math
import statistics

import torch

from benchmark.reference.tracer import accumulate, frame_blend
from benchmark.reference.train import adam_steps

F32_EPS = 2.0 ** -23
# a leaf whose first gradient (its root mean square, so that a leaf's
# size does not decide) is under this share of the median leaf's moves
# by round-off alone
STILL_LEAF = 1e-3


def block_rows(traffic, opts) -> int:
    return max(1, traffic.get("reference_block_pixels", 1 << 30)
               // opts["width"])


def pixels_off(pre, post, color, frame: int, atol: float) -> float:
    """Share of pixels of one checked frame on which the program's
    accumulator after it differs from the reference's by more than the
    tolerance, in colour units. NaN counts as off."""
    blend = frame_blend(frame)
    want = accumulate(pre, color, blend)
    diff = (post - want).abs() / blend
    scale = torch.maximum(post.abs(), want.abs())
    tol = atol + 4.0 * F32_EPS * scale / blend
    off = ~(diff <= tol)
    return off.any(dim=0).double().mean().item()


def _or_inf(x: float) -> float:
    """A gap that is NaN (a side that produced NaN) reads as infinite."""
    return x if x == x else float("inf")


def reference_train(inputs, traffic: dict, dtype=torch.float32, live=None,
                    rows=None, steps=None, block=None) -> dict:
    """The reference's first ``steps`` training steps (a dispatch's K by
    default) from the inputs: {"losses", "params", "grad_norms"} (the
    last, each leaf's first gradient's norm); ``rows`` counts only the
    first image rows in the loss (a planted fault)."""
    if inputs.opts["spp"] != 1 or inputs.opts["rng"] != "counter":
        raise ValueError("the reference trains one counter-RNG sample a step")
    steps = traffic["steps_per_dispatch"] if steps is None else steps
    frames = [inputs.frame0 + i for i in range(steps)]
    grad_norms = {}
    losses, params, _, _ = adam_steps(
        inputs.scene, inputs.tex, inputs.tex_w, inputs.tex_h, inputs.opts,
        inputs.params0, inputs.target_frame, frames, traffic["lr"],
        traffic["eps"], block or block_rows(traffic, inputs.opts), dtype,
        live, rows, grad_norms)
    return {"losses": losses, "params": params, "grad_norms": grad_norms}


def _change_norms(params: dict, start: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(params[k].double()
                                              - start[k].double()))
            for k in start}


def compare_train(inputs, prog: dict, ref: dict) -> dict:
    """``loss_gap``: the first step's loss, relative gap. ``change_gap``:
    the worst relative gap between the norms of the program's and the
    reference's change over the steps the reference followed, over the
    leaves that move by more than round-off (``STILL_LEAF``); a NaN on
    either side reads as infinite. The per-leaf gaps, the leaves' first
    gradient norms and the later losses are returned for the log."""
    lp = [float(x) for x in prog["losses"]]
    lr_ = [float(x) for x in ref["losses"]]
    gaps = [_or_inf(abs(a - b) / max(abs(b), 1e-30)) for a, b in zip(lp, lr_)]
    out = {"loss_gap": gaps[0], "step_loss_gaps": gaps}
    if "params" in prog and "params" in ref:
        start = inputs.params0
        dp = _change_norms(prog["params"], start)
        dr = _change_norms(ref["params"], start)
        leaf_gaps = {k: _or_inf(abs(dp[k] - dr[k]) / max(dr[k], 1e-30))
                     for k in start}
        norms = ref.get("grad_norms") or {k: 1.0 for k in start}
        rms = {k: norms[k] / math.sqrt(start[k].numel()) for k in start}
        floor = STILL_LEAF * statistics.median(rms.values())
        compared = [k for k in start if rms[k] >= floor]
        out.update(change_gap=max(leaf_gaps[k] for k in compared),
                   leaf_change_gaps=leaf_gaps, leaf_grad_norms=norms,
                   leaves_compared=compared)
    return out
