"""The training reference (``benchmark/reference/train.py``) on the CPU:
at one sample a step it is bit for bit the one-sample reference it
replaced (a frozen copy below), and at two samples a step it agrees with
the program's plain route (``backend="torch"``: ``render_for_params``
and ``image_loss`` under autograd) to float32 rounding."""

import math

import torch

from benchmark.harness import check, port
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_cell
from benchmark.reference import train
from benchmark.reference.tracer import render_planes, sample_color, tables
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    loss_and_grad,
    render_for_params,
)

CPU = torch.device("cpu")
F32_EPS = 2.0 ** -23


def _frozen_blocks(height, block_rows):
    for row0 in range(0, height, block_rows):
        yield row0, min(block_rows, height - row0)


def _frozen_target(scene, tex, tex_w, tex_h, opts, frame, block_rows):
    tabs = tables(scene, opts)
    with torch.no_grad():
        return torch.cat([
            sample_color(render_planes(tabs, opts, frame, row0=r0, rows=n),
                         tex, tex_w, tex_h, opts)[0]
            for r0, n in _frozen_blocks(opts["height"], block_rows)], dim=1)


def _frozen_loss_and_grads(scene, params, tex_w, tex_h, opts, frame, target,
                           block_rows, live=None):
    n_px = opts["width"] * opts["height"]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    sse = 0.0
    for r0, n in _frozen_blocks(opts["height"], block_rows):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        tabs = tables(scene, opts, albedo=leaves["albedo"],
                      centers=leaves["sphere_centers"])
        planes = render_planes(tabs, opts, frame, row0=r0, rows=n, live=live)
        color, _ = sample_color(planes, leaves["env_rgb"].t(), tex_w, tex_h,
                                opts)
        err = ((color - target[:, r0:r0 + n]) ** 2).sum()
        part = torch.autograd.grad(err / (3 * n_px), list(leaves.values()),
                                   allow_unused=True)
        for (k, _), g in zip(leaves.items(), part):
            if g is not None:
                grads[k] += g
        sse += float(err.detach())
    return sse / (3 * n_px), grads


def _frozen_adam_steps(scene, tex, tex_w, tex_h, opts, params0, target_frame,
                       frames, lr, eps, block_rows, live, first_grads):
    """The one-sample reference as it was, its first gradient kept."""
    target = _frozen_target(scene, tex, tex_w, tex_h, opts, target_frame,
                            block_rows)
    params = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []
    for t, frame in enumerate(frames, start=1):
        loss, grads = _frozen_loss_and_grads(scene, params, tex_w, tex_h, opts,
                                             frame, target, block_rows,
                                             live if t == 1 else None)
        losses.append(loss)
        if t == 1:
            first_grads.update(grads)
        bc1, bc2 = 1.0 - train.BETA1 ** t, 1.0 - train.BETA2 ** t
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = train.BETA1 * m[k] + (1.0 - train.BETA1) * g
                v2[k] = train.BETA2 * v2[k] + (1.0 - train.BETA2) * g * g
                step = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps)
                params[k] = params[k] - lr * step
    return losses, params, m, v2


def _inputs(spp, seed=2 ** 31 + 21):
    """A training cell's inputs at 24x12, 2 bounces, a 16x8 env map."""
    cell = load_cell("glass_720p.train")
    cell.config["render"].update(width=24, height=12, bounces=2)
    cell.config["env"] = dict(cell.config["env"], width=16, height=8)
    cell.traffic["render"] = dict(cell.traffic["render"], spp=spp)
    return cell, make_inputs(cell, seed, CPU)


def test_one_sample_a_step_is_the_reference_it_replaced():
    """Three steps in blocks of 5 rows (the last one short): losses,
    parameters, moments, the first gradient and the live paths equal."""
    cell, inputs = _inputs(1)
    t = cell.traffic
    frames = [inputs.frame0 + i for i in range(3)]
    args = (inputs.scene, inputs.tex, inputs.tex_w, inputs.tex_h, inputs.opts,
            inputs.params0, inputs.target_frame, frames, t["lr"], t["eps"], 5)
    live_new, live_old, g_new, g_old = [], [], {}, {}
    new = train.adam_steps(*args, live=live_new, first_grads=g_new)
    old = _frozen_adam_steps(*args, live_old, g_old)
    assert new[0] == old[0] and live_new == live_old
    for got, want in zip((*new[1:], g_new), (*old[1:], g_old)):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_two_samples_a_step_match_the_programs_plain_route(monkeypatch):
    """Each side renders its own target and takes the first step's loss
    and gradient; every sample is rendered by the same float32 arithmetic
    on both sides, so they differ by the order of the loss's sums."""
    monkeypatch.setattr(port, "BACKEND", "torch")
    cell, inputs = _inputs(2)
    scene, camera, tex = port.program_scene(inputs, CPU)
    cfg = port.render_config(inputs.opts)
    assert cfg.spp == 2 and cfg.backend == "torch"
    with torch.no_grad():
        target = render_for_params({}, scene, camera, tex, cfg,
                                   inputs.target_frame)
    loss, grads = loss_and_grad(inputs.params0, target, scene, camera, tex,
                                cfg, inputs.frame0)
    rows = check.block_rows(cell.traffic, inputs.opts)
    ref_target = train.render_target(inputs.scene, inputs.tex, inputs.tex_w,
                                     inputs.tex_h, inputs.opts,
                                     inputs.target_frame, rows)
    ref_loss, ref_grads = train.loss_and_grads(
        inputs.scene, inputs.params0, inputs.tex_w, inputs.tex_h, inputs.opts,
        inputs.frame0, ref_target, rows)
    assert torch.equal(target, ref_target)
    # the two sides sum the 3 * 288 squares in other orders: a few ulps
    # of the loss for each halving of the sum
    n = 3 * inputs.opts["width"] * inputs.opts["height"]
    assert abs(float(loss) - ref_loss) <= 4 * math.log2(n) * F32_EPS * ref_loss
    for k, g in ref_grads.items():
        norm = torch.linalg.vector_norm
        assert norm(grads[k] - g) <= 16 * F32_EPS * norm(g), k

