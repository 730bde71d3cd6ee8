"""Compare the training step of two checkouts of the port on one GPU.

    python -m cpuperformanceraytracer_tpu_torch.app.train_ab \\
        --trees build/parent . --pairs 10 --out out/train_ab

Each run is a fresh process started from a tree's root (``PYTHONPATH``
set to it), in the order A B B A, A B B A, ... so that a drift of the
machine during the call falls on both trees alike. A run measures the
training step of ``chip_smoke.py`` phase 8 (1280x720 glass_spheres, 8
bounces, counter RNG, env ``gradient_sky(512, 256)``, the
``default_bench_params``) through the API both trees share:

- ``ms_per_step``: ``fwd_bwd_benchmark``, 2 warmup + 64 timed steps in
  2 spans (host clock between device synchronisations);
- ``host_enqueue_ms``: the host's time to enqueue one step while a sleep
  kernel holds the stream (so no call waits for the device), the mean
  of 16 windows of 2 steps;
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
from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
    default_bench_params, fwd_bwd_benchmark)
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
r = fwd_bwd_benchmark(cfg, scene, cam, tex, steps=64, warmup_steps=2,
                      spans=2)
params = default_bench_params(scene, tex)
with torch.no_grad():
    target = render_for_params({}, scene, cam, tex, cfg, 0)

def step():
    loss_and_grad(params, target, scene, cam, tex, cfg, 1)

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
    "ms_per_step": r["ms_per_step"], "span_ms": r["span_ms"],
    "host_enqueue_ms": enqueue, "device_busy_ms": busy,
    "host_top": [[round(t, 4), c, name] for t, c, name in top],
    "gpu": gpu}))
"""

METRICS = ("ms_per_step", "host_enqueue_ms", "device_busy_ms")


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
        print(json.dumps({"tree": tree, "runs": len(mine), **{
            k: {"mean": statistics.mean(r[k] for r in mine),
                "min": min(r[k] for r in mine),
                "max": max(r[k] for r in mine)} for k in METRICS}}),
            flush=True)
    if a.out:
        with open(os.path.join(a.out, "runs.jsonl"), "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
