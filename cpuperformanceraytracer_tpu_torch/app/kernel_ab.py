"""Compare kernels A, C, D and G of two or more checkouts of the port on
one GPU.

    python -m cpuperformanceraytracer_tpu_torch.app.kernel_ab \\
        --trees build/parent . --out out/kernel_ab

Each run is a fresh process started from a tree's root (``PYTHONPATH``
set to it), in the order A B B A for two trees (A B C C B A for three),
repeated ``--pairs`` times, so that a drift of the machine during the
call falls on every tree alike. Each tree builds its own kernels from its
own sources. A run, through the API the trees share:

- renders kernel A's 12 planes at three shapes and keeps them under
  ``--planes`` (1280x720 glass_spheres 8 bounces wang, frame 0; one
  1920x1080 counter-RNG sample of textured_1080, frame 3, sample 5;
  cornell_box 128x32 3 bounces, spp 2, wang, frame 7);
- times kernel A at the first two shapes (CUDA events over 20 launches
  back to back, and with the stream held full, ``utils/timing.device_ms``);
- checks kernel D (cot_mt equal to ``g * tex[idx]``; the largest texel
  error over its (k - 1) * 2^-24 * sum|v| bound, under 1 when it holds)
  and times it and ``index_add_`` at 720p, held full, on the training
  step's inputs: counter-RNG planes of frame 1, kernel B's texel indices
  into ``gradient_sky(512, 256)`` and a seeded cotangent;
- times kernel C at 720p, held full, on the training step's cotangent
  inputs (a seeded cot6 on frame 1), and keeps its table cotangents under
  ``--planes``; where the tree's wrapper takes them, its lane utilisation
  and the clock64 split of an instrumented launch;
- times kernel G on a seeded 1920x1080 accumulator, held full;
- runs the forward workload (2 warmup + 64 frames) and textured_1080
  (2 warmup + 16 frames) through ``OfflineRenderer`` for their ms/frame;
- reports kernel A's lane utilisation where the tree's wrapper counts
  it, and the ptxas lines of the tree's kernels.

Then every run's planes are compared with the first run's, bit for bit:
the parity of the trees' kernel A (and the determinism of each); and
every run's kernel C cotangents with the first run's, each table within
2e-2 relative L2 (phase 6 of ``chip_smoke.py``: the trees may sum in
other orders), and the bits that differ are counted. Prints
one JSON line per run, a summary line per tree (mean, min, max) and a
parity line; the lines also go to ``<out>/runs.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

CHILD = r"""
import inspect, json, os, subprocess, sys
import torch
from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS, RenderConfig
from cpuperformanceraytracer_tpu_torch.kernels import _build
from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
from cpuperformanceraytracer_tpu_torch.kernels.tonemap import tonemap
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import pack_tables, render_planes
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

planes_dir, tag = sys.argv[1], sys.argv[2]
dev = torch.device("cuda")
build = _build.build()
ptxas = [ln.strip() for ln in build.log.splitlines()
         if "registers" in ln or "spill" in ln or "Compiling entry" in ln]

def cuda_ms(fn, n):
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n

fwd = RenderConfig(width=1280, height=720, bounces=8, spp=1,
                   scene="glass_spheres", env_mode="equirect",
                   env_sampling="stochastic", rng="wang", warmup_frames=2,
                   num_frames=64, backend="cuda")
tex_cfg = BENCH_CONFIGS["textured_1080"].replace(warmup_frames=2, num_frames=16,
                                                 backend="cuda")
one = tex_cfg.replace(spp=1)
cornell = RenderConfig(width=128, height=32, bounces=3, spp=2,
                       scene="cornell_box", env_mode="none", rng="wang")
glass = pack_tables(*scene_by_name("glass_spheres", device=dev), fwd, dev)
shapes = {"720p_wang": (glass, fwd, 0, 0), "1080p_counter": (glass, one, 3, 5),
          "cornell_128x32_spp2_wang": (
              pack_tables(*scene_by_name("cornell_box", device=dev), cornell, dev),
              cornell, 7, 0)}
res = {"tag": tag}
counts_lanes = "lane_stats" in inspect.signature(render_planes).parameters
for name, (tables, cfg, frame, s0) in shapes.items():
    out = render_planes(tables, cfg, frame, sample0=s0)
    torch.cuda.synchronize()
    torch.save(out.cpu(), os.path.join(planes_dir, f"{tag}_{name}.pt"))
    if name == "cornell_128x32_spp2_wang":
        continue
    res[f"A_{name}_ms"] = cuda_ms(lambda: render_planes(tables, cfg, frame, s0, out), 20)
    res[f"A_{name}_held_ms"] = device_ms(
        lambda: render_planes(tables, cfg, frame, s0, out), 20, dev)
    if counts_lanes:
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        render_planes(tables, cfg, frame, s0, out, lane_stats=stats)
        live, slots = stats.tolist()
        res[f"A_{name}_lane_utilisation"] = live / slots

env = texture_from_array(gradient_sky(512, 256), dev)
train = fwd.replace(rng="counter")
planes = render_planes(glass, train, 1)
idx = torch.empty((720, 1280), dtype=torch.int64, device=dev)
env_accumulate(planes, env, train, torch.zeros((3, 720, 1280), device=dev), 1.0,
               index_out=idx)
g = torch.randn((3, 720, 1280), device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
mt = planes[6:9]
vals = (g * mt).reshape(3, -1).t().contiguous()
flat = idx.reshape(-1)
scatter = torch.zeros((env.width * env.height, 3), device=dev)
cot, d_tex = env_backward(g, idx, mt, env)
count = torch.bincount(flat, minlength=scatter.shape[0]).double()
allow = torch.clamp(count - 1.0, min=8.0) * 2.0 ** -24
worst = 0.0
for c in range(3):
    v = (g[c] * mt[c]).reshape(-1).double()
    exact = torch.zeros_like(count).index_add_(0, flat, v)
    mag = torch.zeros_like(count).index_add_(0, flat, v.abs())
    err = (d_tex[c].double() - exact).abs()
    worst = max(worst, (err / (allow * mag + 2.0 * count * 2.0 ** -126)
                        ).nan_to_num(0.0).max().item())
res["D_cot_equal"] = bool(torch.equal(cot, g * torch.stack(
    [env.r[idx], env.g[idx], env.b[idx]])))
res["D_err_over_bound"] = worst
res["D_ms"] = cuda_ms(lambda: env_backward(g, idx, mt, env), 200)
res["D_held_ms"] = device_ms(lambda: env_backward(g, idx, mt, env), 40, dev)
res["index_add_held_ms"] = device_ms(lambda: scatter.index_add_(0, flat, vals), 200, dev)

cot6 = torch.randn((6, 720, 1280), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
d_tables = bwd_tables(glass, train, 1, 0, cot6)
torch.save([t.cpu() for t in d_tables], os.path.join(planes_dir, f"{tag}_C.pt"))
res["C_held_ms"] = device_ms(lambda: bwd_tables(glass, train, 1, 0, cot6), 20, dev)
c_params = inspect.signature(bwd_tables).parameters
if "lane_stats" in c_params:
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    clocks = torch.zeros(6, dtype=torch.int64, device=dev)
    bwd_tables(glass, train, 1, 0, cot6, lane_stats=stats)
    bwd_tables(glass, train, 1, 0, cot6, clocks=clocks)
    res["C_lane_utilisation"] = stats[0].item() / stats[1].item()
    res["C_clock64_split"] = dict(zip(
        ("refill", "segment", "finish", "sums", "rows_out"),
        (v / clocks[5].item() for v in clocks.tolist())))
acc = torch.rand((3, 1080, 1920), device=dev,
                 generator=torch.Generator(device=dev).manual_seed(4)) * 8.0
res["G_held_ms"] = device_ms(lambda: tonemap(acc), 200, dev)

scene, cam = scene_by_name("glass_spheres", device=dev)
res["forward_ms_per_frame"] = OfflineRenderer(
    fwd, texture=env, scene=scene, camera=cam, silent=True).run().mean_ms
big = texture_from_array(gradient_sky(2048, 1024), dev)
res["textured_ms_per_frame"] = OfflineRenderer(
    tex_cfg, texture=big, scene=scene, camera=cam, silent=True).run().mean_ms
res["ptxas"] = ptxas
res["gpu"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60).stdout.strip().splitlines()[0]
print("RESULT " + json.dumps(res))
"""

METRICS = ("A_720p_wang_ms", "A_720p_wang_held_ms", "A_1080p_counter_ms",
           "A_1080p_counter_held_ms", "C_held_ms", "C_lane_utilisation",
           "G_held_ms", "D_ms", "D_held_ms", "index_add_held_ms",
           "forward_ms_per_frame", "textured_ms_per_frame",
           "A_720p_wang_lane_utilisation", "A_1080p_counter_lane_utilisation")
SHAPES = ("720p_wang", "1080p_counter", "cornell_128x32_spp2_wang")


def run_tree(tree: str, planes_dir: str, tag: str, timeout: float) -> dict:
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", CHILD, planes_dir, tag],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def parity(planes_dir: str, tags: list) -> dict:
    """Per shape: the elements of each run's planes that differ, bit for
    bit, from the first run's (per plane)."""
    out = {}
    for shape in SHAPES:
        ref = torch.load(os.path.join(planes_dir, f"{tags[0]}_{shape}.pt"))
        bits = ref.view(torch.int32)
        out[shape] = {
            tag: (torch.load(os.path.join(planes_dir, f"{tag}_{shape}.pt"))
                  .view(torch.int32) != bits).sum(dim=(1, 2)).tolist()
            for tag in tags[1:]}
    return out


def kernel_c_agreement(planes_dir: str, tags: list) -> dict:
    """Per run: each table's relative L2 distance of kernel C's cotangents
    from the first run's, and the cells whose bits differ."""
    ref = torch.load(os.path.join(planes_dir, f"{tags[0]}_C.pt"))
    out = {}
    for tag in tags[1:]:
        got = torch.load(os.path.join(planes_dir, f"{tag}_C.pt"))
        out[tag] = {
            "rel_l2": [((g.double() - r.double()).norm()
                        / r.double().norm().clamp_min(1e-300)).item()
                       for g, r in zip(got, ref)],
            "bits_differ": [int((g.view(torch.int32) != r.view(torch.int32)).sum())
                            for g, r in zip(got, ref)]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_ab")
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--planes", default="build/kernel_ab",
                    help="where the runs' planes go (some 150 MB a run)")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    if len(a.trees) < 2:
        ap.error("--trees needs two checkouts or more")
    order = []
    for _ in range(a.pairs):
        order += list(a.trees) + list(reversed(a.trees))
    planes_dir = os.path.abspath(a.planes)
    os.makedirs(planes_dir, exist_ok=True)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    rows = []
    for i, tree in enumerate(order):
        row = dict(run=i, tree=tree, **run_tree(tree, planes_dir, f"run{i}",
                                                a.timeout))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = []
    for tree in a.trees:
        mine = [r for r in rows if r["tree"] == tree]
        summary.append({"tree": tree, "runs": len(mine), **{
            k: {"mean": statistics.mean(r[k] for r in mine),
                "min": min(r[k] for r in mine),
                "max": max(r[k] for r in mine)}
            for k in METRICS if all(k in r for r in mine)}})
        print(json.dumps(summary[-1]), flush=True)
    diff = parity(planes_dir, [r["tag"] for r in rows])
    c_diff = kernel_c_agreement(planes_dir, [r["tag"] for r in rows])
    line = {"parity_vs_run0": diff, "bit_equal": all(
        sum(v) == 0 for per in diff.values() for v in per.values()),
        "kernel_c_vs_run0": c_diff, "kernel_c_within_2e-2": all(
            max(v["rel_l2"]) < 2e-2 for v in c_diff.values()),
        "runs": {r["tag"]: r["tree"] for r in rows}}
    print(json.dumps(line), flush=True)
    if a.out:
        with open(os.path.join(a.out, "runs.jsonl"), "w") as f:
            for r in rows + summary + [line]:
                f.write(json.dumps(r) + "\n")
    return 0 if line["bit_equal"] and line["kernel_c_within_2e-2"] else 1


if __name__ == "__main__":
    sys.exit(main())
