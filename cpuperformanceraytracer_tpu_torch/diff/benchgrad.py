"""The timed fwd+bwd training step: the repo's headline metric
("Mrays/s/chip fwd+bwd at 1280x720 8-bounce", ``bench.py``), and K steps
per dispatch.

Counterpart of ``cpuperformanceraytracer_tpu.diff.benchgrad``: the
value-and-grad of the L2 pixel loss against a target rendered at frame 0
with no parameters applied, over ``default_bench_params``, with JAX's
protocol: warmup calls, one untimed span, then ``spans`` independently
timed spans; each step takes a fresh frame (a fresh counter-RNG sample
set), and a span is timed on the host clock between two device
synchronisations.

``make_grad_step_k`` fuses K steps into one dispatch, as the JAX
``lax.scan`` does. On the card the dispatch is one CUDA graph: the
training step launches a few hundred small kernels beside kernels A-D,
and enqueueing them one by one from the host takes longer than the
device needs to run them, so the host sets the pace of an ungraphed
step (``PERF.md`` §5). A graph replay enqueues all K steps at once.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from cpuperformanceraytracer_tpu_torch.diff.graph import StepGraph
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    fixed_quad_table,
    image_loss,
    render_for_params,
    value_and_grad,
)


def grad_steps(loss_fn: Callable, params: Dict, frames) -> tuple:
    """``(grad_sum, losses)``: the value-and-grad of ``loss_fn`` at each
    of ``frames`` in turn, ungraphed, the gradients summed in step order
    from zeros (the JAX scan's carry)."""
    sums = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []
    for frame in frames:
        loss, grads = value_and_grad(loss_fn, params, frame)
        sums = {k: sums[k] + grads[k] for k in sums}
        losses.append(loss)
    return sums, torch.stack(losses)


def make_grad_step_k(loss_fn: Callable, k: int) -> Callable:
    """``(params, frame0) -> (grad_sum, losses)``: K value-and-grad steps
    of ``loss_fn(params, frame)`` in one dispatch. Step i takes frame
    ``frame0 + i``; ``grad_sum`` is a dict like ``params``, ``losses`` a
    (k,) tensor.

    On the CPU the K steps run in a loop. On the card the first call
    captures them into one CUDA graph (``diff/graph.StepGraph``); every
    call copies ``params`` into the graph's inputs and replays it with
    ``frame0``. Everything else the steps read (the scene, camera,
    texture and target ``loss_fn`` holds) is read where the capture found
    it."""
    graph = static = None

    def step_k(params: Dict, frame0: int):
        nonlocal graph, static
        device = next(iter(params.values())).device
        if device.type != "cuda":
            return grad_steps(loss_fn, params, [int(frame0) + i for i in range(k)])
        if graph is None:
            static = {n: v.detach().clone() for n, v in params.items()}
            graph = StepGraph(lambda frames: grad_steps(loss_fn, static, frames),
                              k, device)
        if {n: (v.shape, v.dtype, v.device) for n, v in params.items()} != {
                n: (v.shape, v.dtype, v.device) for n, v in static.items()}:
            raise ValueError("make_grad_step_k: params differ in keys, shape, "
                             "dtype or device from the captured ones")
        for n, v in params.items():
            static[n].copy_(v)
        sums, losses = graph.replay(frame0)
        return {n: v.clone() for n, v in sums.items()}, losses.clone()

    return step_k


def default_bench_params(scene, texture) -> Dict:
    """Sphere centers + material albedos (+ every env texel when there is
    a texture), perturbed off the truth so gradients are non-trivial."""
    m, s = scene.materials.albedo, scene.spheres.center
    params = {"albedo": torch.stack([m.x, m.y, m.z], -1) + 0.05,
              "sphere_centers": torch.stack([s.x, s.y, s.z], -1) + 0.1}
    if texture is not None:
        params["env_rgb"] = torch.stack([texture.r, texture.g, texture.b], -1)
    return params


def bench_loss(cfg, scene, camera, texture) -> Callable:
    """``loss_fn(params, frame)``: the L2 pixel loss against the target
    rendered at frame 0 with no parameters applied. The scene's quad
    table is derived here, once, for the steps whose params move no
    quad."""
    with torch.no_grad():
        target = render_for_params({}, scene, camera, texture, cfg, 0)
    quad_tbl = fixed_quad_table(scene)

    def loss_fn(params, frame):
        return image_loss(render_for_params(params, scene, camera, texture,
                                            cfg, frame, quad_tbl), target)

    return loss_fn


def fwd_bwd_benchmark(cfg, scene, camera, texture,
                      params: Optional[Dict] = None, steps: int = 64,
                      steps_per_dispatch: int = 16, warmup_calls: int = 6,
                      spans: int = 2) -> Dict:
    """Measure loss-and-grad throughput; returns ms_per_step, Mrays_per_s,
    the per-span times and their relative spread, K, the last loss, and
    whether every gradient is finite.

    ``steps`` timed step equivalents (rounded to whole dispatches of
    ``steps_per_dispatch``) are split over ``spans`` spans, after
    ``warmup_calls`` synchronised calls and one untimed span of the
    timed spans' shape. K = 1 is the per-step loop: one ungraphed step a
    call; K > 1 runs ``make_grad_step_k``."""
    cfg = cfg.validate()
    if params is None:
        params = default_bench_params(scene, texture)
    loss_fn = bench_loss(cfg, scene, camera, texture)
    k = max(1, min(steps_per_dispatch, steps))
    if k == 1:
        def step_k(p, frame0):
            loss, grads = value_and_grad(loss_fn, p, frame0)
            return grads, loss
    else:
        step_k = make_grad_step_k(loss_fn, k)
    device = next(iter(params.values())).device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    grads = losses = None
    for _ in range(warmup_calls):
        grads, losses = step_k(params, 0)
        sync()
    calls_per_span = max(1, steps // (k * spans))
    for _ in range(calls_per_span):
        grads, losses = step_k(params, 0)
    sync()

    span_ms = []
    frame0 = 1
    for _ in range(spans):
        t0 = time.perf_counter()
        for _ in range(calls_per_span):
            grads, losses = step_k(params, frame0)
            frame0 += k
        sync()
        span_ms.append((time.perf_counter() - t0)
                       / (calls_per_span * k) * 1e3)

    ms = sum(span_ms) / len(span_ms)
    rays = cfg.width * cfg.height * cfg.spp
    return {
        "ms_per_step": ms,
        "Mrays_per_s": rays / ms / 1e3,
        "span_ms": [round(s, 3) for s in span_ms],
        "spread": (max(span_ms) - min(span_ms)) / ms if len(span_ms) > 1
        else 0.0,
        "steps_per_dispatch": k,
        "steps_timed": calls_per_span * k * len(span_ms),
        "loss": float(losses.reshape(-1)[-1]),
        "grads_finite": all(bool(torch.isfinite(g).all())
                            for g in grads.values()),
        "param_leaves": sorted(params),
    }
