"""The plain reference of the inverse-render training step: the L2 pixel
loss of a frame of ``spp`` counter-RNG samples against a target, its
gradient by autograd through ``tracer.py``, and Adam.

The target is rendered here from the true scene and texels; each step
renders the frame it is given with the current parameters (material
albedos, sphere centers, every env texel), takes the mean squared error
against the target, and updates the parameters by Adam (bias-corrected
moments, ``eps`` added outside the square root). A frame's colour is the
mean of its samples, sample s keyed as ``sample0 = s``, each sample's
colour its emitted radiance plus its own env tap times its throughput;
autograd sums the samples' gradients. The image is rendered and
differentiated in blocks of rows, so that the saved intermediates of
one block are all autograd holds at a time; the loss is the sum of the
blocks' squared errors over 3 * H * W.
"""

from __future__ import annotations

import torch

from benchmark.reference.tracer import (
    f32_round,
    render_planes,
    sample_color,
    tables,
)

BETA1, BETA2 = 0.9, 0.999


def _blocks(height: int, block_rows: int):
    for row0 in range(0, height, block_rows):
        yield row0, min(block_rows, height - row0)


def _rows(opts: dict, rows) -> int:
    return opts["height"] if rows is None else rows


def frame_rows(tabs, tex, tex_w, tex_h, opts, frame, row0, rows,
               live=None):
    """(3, rows, W) colour of image rows [row0, row0 + rows) of
    ``frame``: the sum of its ``opts["spp"]`` samples' colours times
    1 / spp (one sample's colour as it is). ``live`` receives each
    sample's live paths per segment."""
    one = dict(opts, spp=1)
    acc = None
    for s in range(opts["spp"]):
        planes = render_planes(tabs, one, frame, sample0=s, row0=row0,
                               rows=rows, live=live)
        color, _ = sample_color(planes, tex, tex_w, tex_h, opts)
        acc = color if acc is None else acc + color
    return acc if opts["spp"] == 1 else acc * f32_round(1.0 / opts["spp"])


def render_target(scene, tex, tex_w, tex_h, opts, frame, block_rows,
                  dtype=torch.float32):
    """(3, H, W) colour of the true scene at ``frame``."""
    tabs = tables(scene, opts, dtype)
    tex = tex.to(dtype)
    with torch.no_grad():
        return torch.cat([
            frame_rows(tabs, tex, tex_w, tex_h, opts, frame, r0, n)
            for r0, n in _blocks(opts["height"], block_rows)], dim=1)


def loss_and_grads(scene, params, tex_w, tex_h, opts, frame, target,
                   block_rows, live=None, rows=None):
    """(loss as a Python float, {name: gradient}) of one step's frame,
    block by block; ``rows`` counts only the first image rows (all by
    default)."""
    dtype = params["albedo"].dtype
    n_px = opts["width"] * _rows(opts, rows)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    sse = 0.0
    for r0, n in _blocks(_rows(opts, rows), block_rows):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        tabs = tables(scene, opts, dtype, albedo=leaves["albedo"],
                      centers=leaves["sphere_centers"])
        color = frame_rows(tabs, leaves["env_rgb"].t(), tex_w, tex_h, opts,
                           frame, r0, n, live)
        err = ((color - target[:, r0:r0 + n]) ** 2).sum()
        part = torch.autograd.grad(err / (3 * n_px), list(leaves.values()),
                                   allow_unused=True)
        for (k, _), g in zip(leaves.items(), part):
            if g is not None:
                grads[k] += g
        sse += float(err.detach())
    return sse / (3 * n_px), grads


def adam_steps(scene, tex, tex_w, tex_h, opts, params0, target_frame, frames,
               lr, eps, block_rows, dtype=torch.float32, live=None,
               rows=None, first_grads=None):
    """Render the target at ``target_frame``, then one Adam step per frame
    of ``frames``. Returns (losses, params, first moments, second
    moments), the last three as dicts of the parameters' names. ``live``
    receives the first step's live paths per segment (and sample and
    block), and ``first_grads`` its gradient per parameter; ``rows``
    counts only the first image rows in the loss."""
    target = render_target(scene, tex, tex_w, tex_h, opts, target_frame,
                           block_rows, dtype)
    params = {k: v.detach().to(dtype).clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []
    for t, frame in enumerate(frames, start=1):
        loss, grads = loss_and_grads(scene, params, tex_w, tex_h, opts, frame,
                                     target, block_rows,
                                     live if t == 1 else None, rows)
        losses.append(loss)
        if t == 1 and first_grads is not None:
            first_grads.update(grads)
        bc1, bc2 = 1.0 - BETA1 ** t, 1.0 - BETA2 ** t
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = BETA1 * m[k] + (1.0 - BETA1) * g
                v2[k] = BETA2 * v2[k] + (1.0 - BETA2) * g * g
                step = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps)
                params[k] = params[k] - lr * step
    return losses, params, m, v2
