"""The timed fwd+bwd training step: the repo's headline metric
("Mrays/s/chip fwd+bwd at 1280x720 8-bounce", ``bench.py``).

Counterpart of ``cpuperformanceraytracer_tpu.diff.benchgrad``: the
value-and-grad of the L2 pixel loss against a target rendered at frame 0
with no parameters applied, over ``default_bench_params``. Warmup steps,
then ``spans`` independently timed spans of steps, each a fresh frame
(a fresh counter-RNG sample set); a span is timed on the host clock
between two device synchronisations, and the result reports the spread.
The K-steps-per-dispatch fusion of the JAX version is a workaround for
the TPU backend's dispatch cost and is not ported.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from cpuperformanceraytracer_tpu_torch.diff.grad import (
    loss_and_grad,
    render_for_params,
)


def default_bench_params(scene, texture) -> Dict:
    """Sphere centers + material albedos (+ every env texel when there is
    a texture), perturbed off the truth so gradients are non-trivial."""
    m, s = scene.materials.albedo, scene.spheres.center
    params = {"albedo": torch.stack([m.x, m.y, m.z], -1) + 0.05,
              "sphere_centers": torch.stack([s.x, s.y, s.z], -1) + 0.1}
    if texture is not None:
        params["env_rgb"] = torch.stack([texture.r, texture.g, texture.b], -1)
    return params


def fwd_bwd_benchmark(cfg, scene, camera, texture,
                      params: Optional[Dict] = None, steps: int = 64,
                      warmup_steps: int = 2, spans: int = 2) -> Dict:
    """Measure loss-and-grad throughput; returns ms_per_step, Mrays_per_s,
    the per-span times and their relative spread, the last loss, and
    whether every gradient is finite. ``steps`` timed steps are split
    evenly over ``spans`` spans."""
    cfg = cfg.validate()
    if params is None:
        params = default_bench_params(scene, texture)
    with torch.no_grad():
        target = render_for_params({}, scene, camera, texture, cfg, 0)

    def sync():
        if target.is_cuda:
            torch.cuda.synchronize(target.device)

    def step(frame):
        return loss_and_grad(params, target, scene, camera, texture, cfg, frame)

    loss = grads = None
    for _ in range(warmup_steps):
        loss, grads = step(0)
    sync()

    per_span = max(1, steps // spans)
    span_ms = []
    frame = 1
    for _ in range(spans):
        t0 = time.perf_counter()
        for _ in range(per_span):
            loss, grads = step(frame)
            frame += 1
        sync()
        span_ms.append((time.perf_counter() - t0) / per_span * 1e3)

    ms = sum(span_ms) / len(span_ms)
    rays = cfg.width * cfg.height * cfg.spp
    return {
        "ms_per_step": ms,
        "Mrays_per_s": rays / ms / 1e3,
        "span_ms": [round(s, 3) for s in span_ms],
        "spread": (max(span_ms) - min(span_ms)) / ms if len(span_ms) > 1
        else 0.0,
        "steps_timed": per_span * len(span_ms),
        "loss": float(loss),
        "grads_finite": all(bool(torch.isfinite(g).all())
                            for g in grads.values()),
        "param_leaves": sorted(params),
    }
