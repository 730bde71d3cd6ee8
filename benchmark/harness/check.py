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

A checkpoint save: its file, read back with ``numpy.load`` (not the
program's loader), holds the format's version, the frame the program
was at, the config's image size and sampling, and planes that equal the
accumulator the save was handed, bit for bit: a save is a copy. The
number compared is the share of saves whose file is missing, unreadable
or different (``save_fault``).

A training dispatch: the reference renders the target and follows the K
steps with autograd and Adam. Compared: the first step's loss (kernels A
and B, the target, the loss); the worst gap, over the parameter leaves,
between the norms of the program's and the reference's change over the
K steps (kernels C and D through the trajectory, Adam); and the worst
gap, over the leaves, between the program's gradient of the first step's
loss and the reference's (``grad_gap``: kernels A to D read directly,
since Adam's steps do not depend on the gradient's scale; the program's
gradient is taken through the call a step makes, at the first step's
parameters, frame and target, called eagerly rather than replayed from
the graph). A leaf whose first gradient in the reference (its root mean
square) is under a thousandth of the median leaf's moves by round-off
alone and is left out of both worst gaps.

A gradient gap is ||g - g_ref|| / ||g_ref|| over a leaf's elements less
the ``TRIM`` at which the two differ most (``trimmed_gap``): a path that
another rounding turns moves its tap from one texel, material or sphere
to another. A leaf whose gradient swings with single bright paths all
the same is found on each run by the reference itself: its first
gradient taken again in float64, a rounding of its own. Where that one
reads over ``STEADY`` from the float32 one by the same gap, the leaf is
left out of ``grad_gap`` (the steadiest leaf stays where none would).

With K steps in one CUDA graph the optimizer's state between steps is
not observable; the later steps' losses swing with single bright paths
(fireflies) that one side's trajectory meets and the other's does not,
so they are logged, not compared (``PERF.md``).
"""

from __future__ import annotations

import json
import math
import statistics
import zipfile
import zlib

import numpy as np
import torch

from benchmark.reference.tracer import accumulate, frame_blend
from benchmark.reference.train import adam_steps

F32_EPS = 2.0 ** -23
# a leaf whose first gradient (its root mean square, so that a leaf's
# size does not decide) is under this share of the median leaf's moves
# by round-off alone
STILL_LEAF = 1e-3
# the elements of a leaf left out of a gradient gap, those at which the
# two sides differ most: two entries (texels, materials or spheres) of
# three channels, the two a turned path moves its tap between
TRIM = 6
# a leaf whose first gradient in the reference, taken in float64, lies
# further than this from the float32 one swings with single bright paths
# and is left out of grad_gap
STEADY = 0.005


def block_rows(traffic, opts) -> int:
    """Rows of a block of the reference: ``reference_block_pixels`` of
    samples held at a time, a row holding width * spp."""
    return max(1, traffic.get("reference_block_pixels", 1 << 30)
               // (opts["width"] * opts["spp"]))


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


# what a save's config has to say of the render it holds
SAVE_CONFIG_KEYS = ("width", "height", "spp", "bounces", "rng")


def save_fault(path, want: torch.Tensor, frame: int, version: int,
               opts: dict):
    """Why the checkpoint at ``path`` is not a whole save of the (3, H, W)
    float32 accumulator ``want`` at ``frame`` in the format ``version``
    (an ``.npz`` of ``version``, ``frame``, the planes ``r``, ``g``,
    ``b`` and ``config``, the JSON of the render's config), or None
    where it is."""
    try:
        with np.load(path, allow_pickle=False) as z:
            got = {k: z[k] for k in ("version", "frame", "r", "g", "b",
                                     "config")}
        cfg = json.loads(str(got["config"]))
    except FileNotFoundError:
        return "missing"
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
            zlib.error) as e:
        return f"unreadable: {type(e).__name__}: {e}"
    if int(got["version"]) != version:
        return f"version {got['version']} for {version}"
    if int(got["frame"]) != frame:
        return f"frame {got['frame']} for {frame}"
    bad = [k for k in SAVE_CONFIG_KEYS if cfg.get(k) != opts[k]]
    if bad:
        return f"config {bad} differ"
    planes = want.cpu().numpy()
    for c, plane in zip("rgb", planes):
        a = got[c]
        if (a.dtype != np.float32 or a.shape != plane.shape
                or not np.array_equal(a.view(np.uint32),
                                      plane.view(np.uint32))):
            return f"plane {c} differs"
    return None


def _or_inf(x: float) -> float:
    """A gap that is NaN (a side that produced NaN) reads as infinite."""
    return x if x == x else float("inf")


def reference_train(inputs, traffic: dict, dtype=torch.float32, live=None,
                    rows=None, steps=None, block=None,
                    witness: bool = False) -> dict:
    """The reference's first ``steps`` training steps (a dispatch's K by
    default) from the inputs: {"losses", "params", "grads", "grad_norms"}
    (the last two, each leaf's first gradient and its norm), and with
    ``witness`` "grads_f64", the first gradient of the same step taken in
    float64; ``rows`` counts only the first image rows in the loss (a
    planted fault)."""
    if inputs.opts["rng"] != "counter":
        raise ValueError("the reference trains counter-RNG samples")
    steps = traffic["steps_per_dispatch"] if steps is None else steps
    frames = [inputs.frame0 + i for i in range(steps)]
    block = block or block_rows(traffic, inputs.opts)
    grads = {}
    losses, params, _, _ = adam_steps(
        inputs.scene, inputs.tex, inputs.tex_w, inputs.tex_h, inputs.opts,
        inputs.params0, inputs.target_frame, frames, traffic["lr"],
        traffic["eps"], block, dtype, live, rows, grads)
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in grads.items()}
    out = {"losses": losses, "params": params, "grads": grads,
           "grad_norms": norms}
    if witness:
        out["grads_f64"] = {}
        adam_steps(inputs.scene, inputs.tex, inputs.tex_w, inputs.tex_h,
                   inputs.opts, inputs.params0, inputs.target_frame,
                   frames[:1], traffic["lr"], traffic["eps"], block,
                   torch.float64, rows=rows, first_grads=out["grads_f64"])
    return out


def trimmed_gap(g: torch.Tensor, ref: torch.Tensor) -> float:
    """||g - ref|| / ||ref|| over the elements less the ``TRIM`` at which
    they differ most (all of them in a leaf of ``2 * TRIM`` or fewer); a
    NaN or an infinity in ``g`` reads as infinite."""
    g, ref = g.double().flatten(), ref.double().flatten()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    diff = g - ref
    if diff.numel() > 2 * TRIM:
        keep = torch.ones_like(diff, dtype=torch.bool)
        keep[diff.abs().topk(TRIM).indices] = False
        diff, ref = diff[keep], ref[keep]
    return _or_inf(float(torch.linalg.vector_norm(diff))
                   / max(float(torch.linalg.vector_norm(ref)), 1e-30))


def _change_norms(params: dict, start: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(params[k].double()
                                              - start[k].double()))
            for k in start}


def compare_train(inputs, prog: dict, ref: dict) -> dict:
    """``loss_gap``: the first step's loss, relative gap. ``change_gap``:
    the worst relative gap between the norms of the program's and the
    reference's change over the steps the reference followed, over the
    leaves that move by more than round-off (``STILL_LEAF``).
    ``grad_gap``, where both sides hold their first gradients
    (``grads``): the worst ``trimmed_gap`` over the same leaves less
    those whose float64 gradient (``grads_f64``, where the reference
    holds it) reads over ``STEADY``. A NaN on either side reads as
    infinite. The per-leaf gaps, the leaves' first gradient norms and
    the later losses are returned for the log."""
    lp = [float(x) for x in prog["losses"]]
    lr_ = [float(x) for x in ref["losses"]]
    gaps = [_or_inf(abs(a - b) / max(abs(b), 1e-30)) for a, b in zip(lp, lr_)]
    out = {"loss_gap": gaps[0], "step_loss_gaps": gaps}
    start = inputs.params0
    norms = ref.get("grad_norms") or {k: 1.0 for k in start}
    rms = {k: norms[k] / math.sqrt(start[k].numel()) for k in start}
    floor = STILL_LEAF * statistics.median(rms.values())
    compared = [k for k in start if rms[k] >= floor]
    if "params" in prog and "params" in ref:
        dp = _change_norms(prog["params"], start)
        dr = _change_norms(ref["params"], start)
        leaf_gaps = {k: _or_inf(abs(dp[k] - dr[k]) / max(dr[k], 1e-30))
                     for k in start}
        out.update(change_gap=max(leaf_gaps[k] for k in compared),
                   leaf_change_gaps=leaf_gaps, leaf_grad_norms=norms,
                   leaves_compared=compared)
    if "grads" in prog and "grads" in ref:
        leaf_gaps = {k: trimmed_gap(prog["grads"][k], ref["grads"][k])
                     for k in start}
        steady = compared
        if "grads_f64" in ref:
            swing = {k: trimmed_gap(ref["grads_f64"][k], ref["grads"][k])
                     for k in compared}
            steady = ([k for k in compared if swing[k] <= STEADY]
                      or [min(compared, key=swing.get)])
            out.update(leaf_grad_swings=swing)
        out.update(grad_gap=max(leaf_gaps[k] for k in steady),
                   leaf_grad_gaps=leaf_gaps, grad_leaves_compared=steady)
    return out
