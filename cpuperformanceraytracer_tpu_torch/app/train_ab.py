"""Compare the training step of two checkouts of the port on one GPU.

    python -m cpuperformanceraytracer_tpu_torch.app.train_ab \\
        --trees build/parent . --pairs 10 --out out/train_ab

Each run is a fresh process started from a tree's root (``PYTHONPATH``
set to it), in the order A B B A, A B B A, ... so that a drift of the
machine during the call falls on both trees alike. A run measures the
training step of ``chip_smoke.py`` phase 8 (1280x720 glass_spheres, 8
bounces, counter RNG, env ``gradient_sky(512, 256)``, the
``default_bench_params``) through the API both trees share:

- ``ms_per_step``: one protocol for both trees, the per-step loop (one
  ungraphed step a call, the step the tree's own bench runs at K = 1): 2
  warmup steps on frame 0, then 64 steps on frames 1-64 in 2 spans, each
  timed on the host clock between device synchronisations;
- ``ms_per_step_k16``: ``fwd_bwd_benchmark`` at K = 16 steps a dispatch
  (one CUDA graph, JAX's protocol), only in a tree that has
  ``make_grad_step_k`` (else null): compare it with the same tree's
  ``ms_per_step``, not with another tree's;
- ``host_enqueue_ms``: the host's time to enqueue the same ungraphed
  step while a sleep kernel holds the stream (so no call waits for the
  device), the mean of 16 windows of 2 steps;
- ``device_busy_ms``: CUDA events around the same windows, the stream
  kept full;
- ``host_top``: the 12 functions with the most own host time over 8
  steps (``cProfile``).

Prints one JSON line per run and a summary line per tree (mean, min,
max); the lines also go to ``<out>/runs.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import cProfile, json, pstats, subprocess, time
import torch
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff import benchgrad
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    loss_and_grad, render_for_params)
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

dev = torch.device("cuda")
cfg = RenderConfig(width=1280, height=720, bounces=8, spp=1,
                   scene="glass_spheres", env_mode="equirect",
                   env_sampling="stochastic", rng="counter", backend="cuda")
tex = texture_from_array(gradient_sky(512, 256), dev)
scene, cam = scene_by_name(cfg.scene, device=dev)
params = benchgrad.default_bench_params(scene, tex)
if hasattr(benchgrad, "bench_loss"):   # the step its bench runs at K = 1
    from cpuperformanceraytracer_tpu_torch.diff.grad import value_and_grad
    loss_fn = benchgrad.bench_loss(cfg, scene, cam, tex)

    def step(frame=1):
        value_and_grad(loss_fn, params, frame)
else:
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)

    def step(frame=1):
        loss_and_grad(params, target, scene, cam, tex, cfg, frame)

for _ in range(2):
    step(0)
torch.cuda.synchronize()
span_ms, frame = [], 1
for _ in range(2):
    t0 = time.perf_counter()
    for _ in range(32):
        step(frame)
        frame += 1
    torch.cuda.synchronize()
    span_ms.append((time.perf_counter() - t0) / 32 * 1e3)
k16 = None
if hasattr(benchgrad, "make_grad_step_k"):
    k16 = benchgrad.fwd_bwd_benchmark(cfg, scene, cam, tex, steps=64,
                                      steps_per_dispatch=16,
                                      spans=2)["ms_per_step"]

# windows of 2 steps (~420 launches): fewer than the stream's launch
# queue holds, or the host would block until the sleep ends
n, enqueue, busy = 2, [], []
for _ in range(16):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4 * n * 10e-3 * 2.0e9))   # ~4x n steps of 10 ms
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    enqueue.append((time.perf_counter() - t0) / n * 1e3)
    end.record()
    if start.query():
        raise AssertionError("the stream drained while steps were enqueued")
    torch.cuda.synchronize()
    busy.append(start.elapsed_time(end) / n)
prof = cProfile.Profile()
torch.cuda.synchronize()
prof.enable()
for _ in range(8):
    step()
torch.cuda.synchronize()
prof.disable()
stats = pstats.Stats(prof).sort_stats("tottime")
top = []
for (file, line, fn), (cc, nc, tt, ct, _) in list(stats.stats.items()):
    top.append((tt / 8 * 1e3, nc // 8, f"{file.rsplit('/', 1)[-1]}:{line}:{fn}"))
top = sorted(top, reverse=True)[:12]
gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60).stdout.strip().splitlines()[0]
print("RESULT " + json.dumps({
    "ms_per_step": sum(span_ms) / len(span_ms), "span_ms": span_ms,
    "ms_per_step_k16": k16,
    "host_enqueue_ms": enqueue, "device_busy_ms": busy,
    "host_top": [[round(t, 4), c, name] for t, c, name in top],
    "gpu": gpu}))
"""

METRICS = ("ms_per_step", "ms_per_step_k16", "host_enqueue_ms",
           "device_busy_ms")


def run_tree(tree: str, timeout: float) -> dict:
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="train_ab")
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    order = []
    for i in range(a.pairs):
        order += list(a.trees) if i % 2 == 0 else list(reversed(a.trees))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    rows = []
    for i, tree in enumerate(order):
        row = dict(run=i, tree=tree, **run_tree(tree, a.timeout))
        for k in ("host_enqueue_ms", "device_busy_ms"):
            row[k] = statistics.mean(row[k])
        rows.append(row)
        print(json.dumps(row), flush=True)
    for tree in a.trees:
        mine = [r for r in rows if r["tree"] == tree]
        summary = {}
        for k in METRICS:
            got = [r[k] for r in mine if r[k] is not None]
            summary[k] = {"mean": statistics.mean(got), "min": min(got),
                          "max": max(got)} if got else None
        print(json.dumps({"tree": tree, "runs": len(mine), **summary}),
              flush=True)
    if a.out:
        with open(os.path.join(a.out, "runs.jsonl"), "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
