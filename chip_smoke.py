"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:

1. device: a CUDA GPU, its name and power limit (nvidia-smi);
2. build: compile csrc/*.cu with nvcc (sm_90a) into build/kernels/;
3. kernel A (forward megakernel) vs its plain-torch version on the card:
   cornell_box 256x64, 2 bounces, no env, all 12 planes at rtol 1e-4,
   atol 1e-5 (wang and counter RNG); glass_spheres + gradient_sky(512,
   256) at 1280x720, 8 bounces, robust: the rgb and miss-throughput means
   within 1e-2 relative, and on every one of the 12 planes (the miss
   direction and env jitter where the ``missed`` flags agree, and the
   flags themselves) under 0.1% of pixels off by > 1e-3; kernel A's lane
   utilisation at 720p (lanes that run a segment over the lane slots of
   all warp iterations): counted by the persistent kernel, and for one
   thread per pixel from the plain version's per-pixel live masks (a
   warp is 32 neighbouring pixels of a row and runs until its longest
   path ends); its ptxas registers and spills, and its resident blocks;
4. kernel B (env resolve + accumulate) vs its plain version on the same
   planes: texel indices equal on >= 99.9% of pixels, the accumulator
   allclose (rtol 1e-5) where they are equal; then the chain kernel A ->
   kernel B vs plain A -> plain B, under 0.1% of pixels off by > 1e-3;
5. main path: OfflineRenderer(backend="cuda") at the bench workload
   (1280x720, glass_spheres, 8 bounces, 1 spp, equirect stochastic env,
   wang RNG), 2 warmup + 64 timed frames; both launch counters must equal
   66; the image is finite with a nonzero mean, and the accumulator
   agrees with the plain-torch path's on the card pixel by pixel (means
   within 1e-2 relative, under 1% of pixels off by > 1e-3: 64 frames, each
   of which may flip a path). The device time per frame is also taken
   with the stream kept full (CUDA events), and the idle share of the
   timed loop is 1 - that / ms per frame;
6. kernel C (the adjoint megakernel) vs its plain version (autograd of
   the plain kernel A) on seeded cotangents: the Beer scene (one glass
   sphere every path refracts through, a geometry gradient) and
   cornell_box without env, 256x64, 2 bounces, every table cotangent
   allclose (rtol 1e-3, atol 1e-3 of the largest reference cotangent:
   the kernel sums in another order); glass_spheres + gradient_sky(512,
   256) at 1280x720, 8 bounces, relative L2 error under 2e-2 per table
   (a lottery flip on a few pixels moves a sum over all pixels); two
   launches bit-equal (fixed-order sums); its lane utilisation (counted
   in the kernel, and for one thread per pixel from the plain version's
   masks), the clock64 split of an instrumented launch (the cycles lane 0
   of every warp spends refilling, in segment(), finishing steps, summing
   into the warps' rows and writing the partials), its time back to back
   and with the stream held full, its ptxas registers and spills;
7. kernel D (env cotangents + texel scatter) vs its plain version at
   1280x720 pixels and 512x256 texels, on kernel B's indices of phase 4:
   cot_mt exactly equal, each texel's sum of k values within
   (k - 1) * 2^-24 * sum|v| (at least 8 * 2^-24 * sum|v|) of a float64
   index_add_; two calls bit-equal (fixed-order sums); the busiest texel
   with and without the zero addends (which the kernel drops), and D, the
   deterministic library call (index_put_ with accumulate, which sorts
   under torch.use_deterministic_algorithms) and index_add_ (atomics)
   with the stream held full;
8. the training path: fwd_bwd_benchmark(backend="cuda") at the bench
   workload (counter RNG, params albedo + 0.05, sphere centers + 0.1 and
   every env texel), JAX's protocol (6 warmup calls, one untimed span,
   64 timed steps in 2 spans), once at K = 16 steps a dispatch (one CUDA
   graph of 16 steps) and once at K = 1 (the per-step loop). Each run is
   traced by torch.profiler, which counts the launches of kernels A, B,
   C and D on the device: one a step of every warmup, untimed and timed
   call, 16 more at K = 16 for the capture's warm-up run, and A and B
   once more for the target; the wrappers' counters, which count no
   capture and cannot see a replay, count the launches outside the
   graph. A second, untraced run of the same bench gives ms/step; for
   each K the device time per step with the stream kept full, the idle
   share and the host's enqueue time per dispatch. torch.profiler over
   one replay of a K = 16 graph counts 16 launches each of A-D and
   splits its device time by kernel; the graphed grad_sum and losses
   bit-equal to 16 ungraphed steps summed in order, and 16 graphed Adam
   steps (capturable) leave
   the parameters and losses bit-equal to 16 ungraphed ones; gradients
   finite and within 2e-2 relative L2 of the plain path's on the card;
   two steps on one frame bit-equal (loss and gradients); the same step
   with a cubemap env (six gradient_sky(256, 256) faces) within 2e-2
   relative L2 of the plain path's; then 8 Adam steps of
   adam_inverse_render on the albedo (one graph of 8), whose loss must
   fall;
9. kernel E (env lookup + texel fetch) vs its plain version on phase 3's
   720p planes, for all six env_mode x env_sampling pairs (equirect
   gradient_sky(512, 256); cubemap six gradient_sky(256, 256) faces):
   taps equal on >= 99.9% of pixels, the rows equal (rtol 1e-6) where
   they agree; gather_texels bit-equal to torch indexing;
10. kernel F (combine + accumulate) vs its plain version on seeded
   1920x1080 inputs at spp 1 and 16: allclose rtol 1e-6;
11. kernel G (display transform) vs its plain version on seeded
   accumulators with 0, 1e-12, 1e-3 and 50 in them and on phase 5's
   accumulator: f32 within rtol 1e-5, u8 equal on >= 99.99% of values
   and never off by more than 1;
12. the textured path: OfflineRenderer(backend="cuda") at textured_1080
   (1920x1080, glass_spheres, 16 spp, 8 bounces, counter RNG, equirect
   stochastic) with a gradient_sky(2048, 1024) env, 2 warmup + 16 timed
   frames; kernels A and E launch 16 times a frame, F once; kernel E vs
   its plain version on one frame's 16 samples at these shapes (1080p
   planes, the 2k env), by phase 9's rules; after 2 frames the
   accumulator agrees with the plain path's on the card (means within
   1e-2, under 1% of pixels off by > 1e-3); the device
   time per frame with the stream kept full and the idle share; one
   720p frame each of bilinear equirect and cubemap nearest through the
   same route, checked the same way; a PNG written through kernel G
   (one launch); G timed at 1080p back to back and held full;
13. checkpoint/resume on the card: 8 textured_1080 frames saved every 4,
   a new renderer resumed for 4 more, bit-equal to 12 frames in one run;
14. the probes (kernels K6-K8, built into their own library in phase 2):
   with the probe kernels' launch counts set to 0, the three probe entry
   points run as a user runs them (``probes.trace_probe``, ``probes.
   gather_bench``, ``probes.overlap_probe``: P1 kernel A and the texel
   gather on two streams, P2 serial row copies, P3 the cluster gather)
   and every probe kernel must have launched; then each kernel against
   its plain version on the card: K6 on the CUDA cores at rtol 1e-6 (the
   same chains in the same order), on the tensor cores (3xTF32) under
   1e-4 max relative error against the CUDA cores; K7 in all three
   layouts, K8a (TMA and cp.async, 512- and 16-byte rows, 256 to 4096
   copies) and K8b (2048 and 921600 queries) bit-equal; last, kernels B,
   D, E and G and ``index_add_`` at 720p timed both ways, back to back
   (as phases 4-12 time them) and with the stream held full (as the
   probes time theirs): where back to back is longer, the host's
   enqueue set its pace;
15. the oracle integrator (backend "oracle", plain torch on the card):
   OfflineRenderer at the forward workload, 1 warmup + 4 timed frames,
   against the kernel route's 4 frames (means within 1e-2, under 1% of
   pixels off by > 1e-3: the oracle takes the sphere normal as
   safe_normalize(hit_rel), kernel A as hit_rel * (1/r)), with its peak
   memory; the cornell box 256x64, 2 bounces, against kernel A at rtol
   1e-4, atol 1e-5; path-replay gradients (diff/path_replay.py) against
   plain autograd through the oracle at 320x180, 8 bounces, bilinear env
   (which the kernel routes refuse), rtol 1e-4 and atol 1e-7, with the
   peak memory and time of each;
16. the parallel layer, the row windows, the native codec and the
   profiler. Right after phase 5: ``make -C native`` and the native RGBE
   decode and BMP encode equal to the numpy path; one forward frame under
   ``utils/profiling.trace``, whose Chrome trace must name kernel A. Last:
   kernels A and C on the lower 360 rows of the 720p frame (A bit-equal to
   those rows of a whole launch, C bit-equal on two launches), each held
   full on the window and on the whole frame; a world of 1 (no process
   group) bit-equal to the unsharded kernel route; a gloo world of 2 ranks
   on the one card (``parallel.mesh.spawn_world``): px = 2 forward frames
   (wang and counter) bit-equal to the unsharded kernel route, px = 1 x
   spp = 2 at spp 2 within 1e-5 absolute, a sharded training step (px =
   2, counter) with its loss within 1e-5 relative and its gradients under
   1e-5 relative L2 of the unsharded K = 1 step, two sharded steps
   bit-equal, the f32 elements its collectives move equal to
   ``parallel/budget``'s model, kernels A-D launched by the ranks (the
   counts set to 0 just before), the sharded step's ms and its gradient
   all-reduce's; then ``parallel.scaling.measure_scaling`` over worlds of
   1 and 2 ranks at the forward workload (two ranks on one card share it:
   their efficiency measures contention and gloo's host staging).

Then one JSON line with each kernel's numbers (times, launches on the
main paths, and the bound: the larger of its bytes over 3.35 TB/s and
its operations over the peak of their type (FP32 67 TFLOP/s, TF32 on
the tensor cores 495 TFLOP/s), counted from this run's inputs; a probe
kernel's launches are those of the probe entry points, on no render
path), the card's nvidia-smi line, and last ``{"ok": true, "device":
{...}}``. Without a GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

WARMUP, FRAMES = 2, 64
STEPS = 64                      # timed training steps (2 spans)
STEPS_PER_DISPATCH = 16         # the training bench's K (JAX's default)
WARMUP_CALLS = 6                # fwd_bwd_benchmark's warmup calls

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32 FLOP/s,
# TF32 tensor-core FLOP/s
PEAK_BYTES, PEAK_FLOPS, PEAK_TF32 = 3.35e12, 67e12, 495e12

# FP32 operations the kernels execute unconditionally, counted from
# csrc/bounce.cuh and csrc/backward.cu (add, sub, mul, div, sqrt, min,
# max, transcendental: 1 each; integer RNG work, comparisons and
# selects not counted, so the bound stays a lower bound)
FLOPS_QUAD, FLOPS_SPHERE = 44, 19      # one ray-object test
FLOPS_SHADE = 200                      # the rest of a segment
FLOPS_CAMERA = 29                      # camera ray + output sum, per pixel
FLOPS_ADJOINT = 110                    # a segment's hand-written adjoint
FLOPS_CAMERA_ADJ = 27


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the least time the card needs for the work."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_FLOPS, tf32_flops / PEAK_TF32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segment_flops(tables) -> int:
    return (FLOPS_QUAD * tables[0].shape[0] + FLOPS_SPHERE * tables[1].shape[0]
            + FLOPS_SHADE)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warm: int = 2) -> float:
    """Mean device milliseconds per call over ``n`` calls (CUDA events)."""
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms_by_kernel(fn, calls: int = 5) -> dict:
    """Device milliseconds per call of ``fn`` by kernel name
    (torch.profiler's CUDA activity)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = us / 1e3 / calls
    return out


def robust(a: torch.Tensor, b: torch.Tensor, what: str, frac: float) -> float:
    """Per-channel robust agreement: means within 1e-2 relative and under
    ``frac`` of pixels off by > 1e-3; returns the share of pixels off."""
    a, b = a.double(), b.double()
    ma, mb = a.mean().item(), b.mean().item()
    off = ((a - b).abs() > 1e-3).double().mean().item()
    if not (abs(ma - mb) < 1e-2 * max(abs(mb), 1e-3) and off < frac):
        raise AssertionError(f"{what}: means {ma:.6g} vs {mb:.6g}, "
                             f"{off:.4%} of pixels off by > 1e-3")
    return off


def device_frame_ms(step, n: int, sleep_cycles: int = 200_000_000,
                    windows: int = 1) -> float:
    """Device milliseconds per call of ``step`` with the stream kept full:
    in each of ``windows`` windows a sleep kernel (~0.1 s at the H100's
    clock by default) holds the stream while the host enqueues ``n``
    calls, so no call waits for the host (CUDA events). A window must
    hold fewer launches than the stream's launch queue, or the host
    blocks until the sleep ends. A window in which the stream drained
    (the host was slower than the sleep) is measured again with a sleep
    four times longer, up to twice."""
    total = 0.0
    for _ in range(windows):
        for sleep in (sleep_cycles, 4 * sleep_cycles, 16 * sleep_cycles):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            torch.cuda._sleep(sleep)
            start.record()
            for _ in range(n):
                step()
            end.record()
            drained = start.query()
            torch.cuda.synchronize()
            if not drained:
                break
        else:
            raise AssertionError("the stream drained while work was enqueued")
        total += start.elapsed_time(end)
    return total / (n * windows)


def ptxas_of(log: str, kernel: str) -> str:
    """ptxas's registers and spills for the entry functions whose mangled
    name holds ``kernel``, from an nvcc -Xptxas -v log."""
    found, current = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            current = kernel in ln
        elif current and ("registers" in ln or "spill" in ln):
            found.append(ln.split(":", 1)[-1].strip() if "registers" in ln
                         else ln.strip())
    return " | ".join(found) or "no ptxas log (the library was already built)"


def lane_utilisation(masks, width: int) -> float:
    """Live segments over 32 x each warp's longest path, for one thread
    per pixel with a warp on 32 neighbouring pixels of a row."""
    live = torch.stack(masks).sum(0)                       # (H, W)
    pad = (-width) % 32
    warps = torch.nn.functional.pad(live, (0, pad)).reshape(live.shape[0], -1, 32)
    return live.sum().item() / (32 * warps.amax(-1).sum().item())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).norm()
            / want.double().norm()).item()


def beer_scene(dev):
    """One glass sphere every path refracts through (refraction chance 1,
    no specular) over a grey floor: decision-stable, with sphere and
    camera gradients through Beer absorption."""
    from cpuperformanceraytracer_tpu_torch.scene.builder import SceneBuilder
    from cpuperformanceraytracer_tpu_torch.scene.camera import make_camera
    from cpuperformanceraytracer_tpu_torch.scene.types import Material

    b = SceneBuilder(translation=(0.0, 0.0, 10.0))
    grey = b.add_material(Material(albedo=(0.6, 0.55, 0.5)))
    glass = b.add_material(Material(
        albedo=(0.9, 0.9, 0.9), specular_chance=0.0, refraction_chance=1.0,
        ior=1.5, refraction_color=(0.5, 0.2, 0.1)))
    b.add_quad((-25.0, -12.45, 15.0), (25.0, -12.45, 15.0),
               (25.0, -12.45, -15.0), (-25.0, -12.45, -15.0), grey)
    b.add_sphere((0.0, -2.0, 0.0), 6.0, glass)
    return b.build(dev), make_camera((0.0, 0.0, 40.0), 90.0, -1.0, device=dev)


TABLES = ("quad", "sphere", "material", "camera")


C_CLOCKS = ("refill", "segment", "finish", "sums", "rows_out")


def phase_kernel_c(dev, glass_tables, glass_cfg, build_log) -> dict:
    """Phase 6: kernel C vs its plain version; its numbers for the JSON."""
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.kernels.backward import (
        bwd_tables,
        bwd_tables_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes_reference,
    )
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    strict_err = 0.0
    small = RenderConfig(width=256, height=64, bounces=2, spp=1, rng="counter",
                         roulette="off")
    cases = (("beer", beer_scene(dev), small),
             ("cornell_box", scene_by_name("cornell_box", device=dev),
              small.replace(scene="cornell_box", env_mode="none",
                            roulette="v4_quirk")))
    for name, (scene, cam), cfg in cases:
        tables = pack_tables(scene, cam, cfg, dev)
        cot6 = torch.randn((6, cfg.height, cfg.width), device=dev, generator=gen)
        got = bwd_tables(tables, cfg, 1, 0, cot6)
        want = bwd_tables_reference(tables, cfg, 1, 0, cot6)
        torch.cuda.synchronize()
        scale = max(w.abs().max().item() for w in want)
        for tbl, g, w in zip(TABLES, got, want):
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * scale,
                                       msg=lambda m: f"kernel C {name} {tbl}: {m}")
            strict_err = max(strict_err, (g - w).abs().max().item())
        if name == "beer" and not (want[1].abs().max() > 0
                                   and want[3][:5].abs().max() > 0):
            raise AssertionError("kernel C: the Beer scene's sphere or camera "
                                 "cotangent is zero")

    cfg = glass_cfg.replace(rng="counter")
    cot6 = torch.randn((6, cfg.height, cfg.width), device=dev, generator=gen)
    got = bwd_tables(glass_tables, cfg, 1, 0, cot6)
    want = bwd_tables_reference(glass_tables, cfg, 1, 0, cot6)
    torch.cuda.synchronize()
    rels = {tbl: rel_l2(g, w) for tbl, g, w in zip(TABLES, got, want)
            if w.norm() > 0}
    if max(rels.values()) >= 2e-2:
        raise AssertionError(f"kernel C glass 1280x720: relative L2 {rels}")
    # fixed-order sums: a second launch gives the same bits
    again = bwd_tables(glass_tables, cfg, 1, 0, cot6)
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again)):
        raise AssertionError("kernel C: two launches differ")
    live, masks = [], []
    render_planes_reference(glass_tables, cfg, 1, 0, live_segments=live,
                            live_masks=masks)
    util_pixel = lane_utilisation(masks, cfg.width)
    del masks
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    clocks = torch.zeros(len(C_CLOCKS) + 1, dtype=torch.int64, device=dev)
    bwd_tables(glass_tables, cfg, 1, 0, cot6, lane_stats=stats)
    bwd_tables(glass_tables, cfg, 1, 0, cot6, clocks=clocks)
    torch.cuda.synchronize()
    util = stats[0].item() / stats[1].item()
    split = {k: v / clocks[-1].item() for k, v in zip(C_CLOCKS, clocks.tolist())}
    ms = cuda_ms(lambda: bwd_tables(glass_tables, cfg, 1, 0, cot6), 10)
    held_ms = device_ms(lambda: bwd_tables(glass_tables, cfg, 1, 0, cot6), 20,
                        dev)
    plain_ms = cuda_ms(
        lambda: bwd_tables_reference(glass_tables, cfg, 1, 0, cot6), 2, 1)
    n_px = cfg.width * cfg.height
    n_cells = sum(t.numel() for t in glass_tables)
    n_blocks = bwd_blocks(glass_tables, cfg)
    # the replay runs every live segment, the reverse sweep all but each
    # pixel's last again (its adjoint reuses the replay's intermediates)
    flops = ((2 * sum(live) - n_px) * segment_flops(glass_tables)
             + sum(live) * FLOPS_ADJOINT
             + n_px * (FLOPS_CAMERA + FLOPS_CAMERA_ADJ))
    bnd = bound(6 * 4 * n_px + 4 * n_blocks * n_cells, flops)
    regs = ptxas_of(build_log, "bwd_tables_kernel")
    phase("kernel C", f"Beer + cornell 256x64 allclose (max abs err "
          f"{strict_err:.3g}); glass 1280x720 8 bounces relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f"; two launches bit-equal; {ms:.4f} ms back to back, "
          f"{held_ms:.4f} held full vs plain {plain_ms:.2f} ms; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}, {sum(live)} live segments); lane "
          f"utilisation {util:.4f} (one thread per pixel: {util_pixel:.4f}); "
          f"clock64 split " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; {n_blocks} blocks; ptxas: {regs}")
    return dict(max_abs_err=strict_err, ms=held_ms, back_to_back_ms=ms,
                plain_ms=plain_ms, bound=bnd, library_ms=None,
                rel_l2_1280x720=rels, live_segments=sum(live),
                bit_equal_twice=True, lane_utilisation=util,
                lane_utilisation_one_thread_per_pixel=util_pixel,
                clock64_split=split, blocks=n_blocks, ptxas=regs)


def bwd_blocks(tables, cfg) -> int:
    """Rows of kernel C's partials: its persistent grid on this card."""
    from cpuperformanceraytracer_tpu_torch.kernels.backward import _grid_blocks

    return _grid_blocks(tables[0].device.index or 0, tables[0].shape[0],
                        tables[1].shape[0], tables[2].shape[0], cfg.bounces,
                        cfg.width, cfg.height)


def phase_kernel_d(dev, planes, idx, tex) -> dict:
    """Phase 7: kernel D vs its plain version and a float64 texel sum."""
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import (
        env_backward,
        env_backward_reference,
    )
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((3,) + tuple(idx.shape), device=dev, generator=gen)
    mt = planes[6:9]
    cot, d_tex = env_backward(g, idx, mt, tex)
    cot_want, _ = env_backward_reference(g, idx, mt, tex)
    _, again = env_backward(g, idx, mt, tex)
    torch.cuda.synchronize()
    if not torch.equal(cot, cot_want):
        raise AssertionError("kernel D: cot_mt differs from the plain version")
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(d_tex, again)):
        raise AssertionError("kernel D: two calls differ")
    n_tex = tex.width * tex.height
    flat = idx.reshape(-1)
    vals = (g * mt).reshape(3, -1).t().contiguous()
    library = torch.zeros((n_tex, 3), device=dev).index_add_(0, flat, vals)
    count = torch.bincount(flat, minlength=n_tex).double()
    # a sum of k f32 terms in any order is within (k - 1) * 2^-24 * sum|v|
    # of the exact sum (at least the fixed 4 * 2^-23 * sum|v| is allowed),
    # plus 2^-126 per add: f32 atomics flush subnormals to zero
    allow = torch.clamp(count - 1.0, min=8.0) * 2.0 ** -24
    ftz = 2.0 * count * 2.0 ** -126
    max_err, worst, over_fixed, lib_over = 0.0, 0.0, 0, 0
    for c in range(3):
        v = vals[:, c].double()
        exact = torch.zeros(n_tex, dtype=torch.float64, device=dev)
        exact.index_add_(0, flat, v)
        mag = torch.zeros_like(exact).index_add_(0, flat, v.abs())
        err = (d_tex[c].double() - exact).abs()
        if (err > allow * mag + ftz).any():
            raise AssertionError(f"kernel D channel {c}: a texel sum is off "
                                 f"by more than (k - 1) * 2^-24 * sum|v|")
        max_err = max(max_err, err.max().item())
        hit = mag > 0
        worst = max(worst, (err[hit] / (allow * mag + ftz)[hit]).max().item())
        fixed = 4 * 2.0 ** -23 * mag
        over_fixed += int((err > fixed).sum())
        lib_over += int(((library[:, c].double() - exact).abs() > fixed).sum())
    nonzero = (vals != 0).any(1)
    busiest_nz = int(torch.bincount(flat[nonzero], minlength=n_tex).max())
    ms = cuda_ms(lambda: env_backward(g, idx, mt, tex), 200)
    plain_ms = cuda_ms(lambda: env_backward_reference(g, idx, mt, tex), 20)
    scatter = torch.zeros((n_tex, 3), device=dev)
    library_ms = cuda_ms(lambda: scatter.index_add_(0, flat, vals), 200)
    # 40 calls a window: a call is some ten launches (the sort's), and a
    # window must stay under the stream's launch queue
    held_ms = device_ms(lambda: env_backward(g, idx, mt, tex), 40, dev)
    library_held_ms = device_ms(lambda: scatter.index_add_(0, flat, vals), 200,
                                dev)
    # the deterministic library call for the same sums: index_put_ with
    # accumulate sorts under torch.use_deterministic_algorithms
    torch.use_deterministic_algorithms(True)
    try:
        def det_call():
            scatter.index_put_((flat,), vals, accumulate=True)

        try:
            det_ms, det_how = device_ms(det_call, 40, dev), "held full"
        except RuntimeError:  # the call waits for the device: time it as it runs
            det_ms, det_how = cuda_ms(det_call, 40), "back to back (it synchronises)"
    finally:
        torch.use_deterministic_algorithms(False)
    # where D's time goes: its two kernels and the library sort between
    by_kernel = device_ms_by_kernel(lambda: env_backward(g, idx, mt, tex))
    split = {"runs": 0.0, "sort": 0.0, "sums": 0.0}
    for name, t in by_kernel.items():
        split["runs" if "env_runs_kernel" in name else
              "sums" if "texel_sums_kernel" in name else "sort"] += t
    n_px = idx.numel()
    bnd = bound(n_px * (12 + 8 + 12 + 12) + 2 * 3 * 4 * n_tex, 9 * n_px)
    phase("kernel D", f"cot_mt equal; two calls bit-equal; texel sums within "
          f"{worst:.3g} of the "
          f"(k-1)*2^-24*sum|v| bound (max abs err {max_err:.3g}; busiest "
          f"texel {int(count.max())} pixels, {busiest_nz} with a nonzero "
          f"addend ({int(nonzero.sum())} of {n_px} pixels); texel sums over "
          f"4*2^-23*sum|v|: {over_fixed} here, {lib_over} with index_add_); "
          f"{ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms vs index_add_ {library_ms:.4f} ms; "
          f"held full {held_ms:.4f} ms vs deterministic index_put_ "
          f"{det_ms:.4f} ms ({det_how}) vs index_add_ (atomics) "
          f"{library_held_ms:.4f} ms; by kernel (profiler) "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + " ms; "
          f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    return dict(max_abs_err=max_err, ms=held_ms, back_to_back_ms=ms,
                plain_ms=plain_ms, bound=bnd, library_ms=det_ms,
                library_call=f"index_put_(accumulate=True), deterministic, "
                             f"{det_how}",
                index_add_ms=library_ms, index_add_held_ms=library_held_ms,
                device_ms_by_part=split,
                bit_equal_twice=True,
                busiest_texel={"all": int(count.max()), "nonzero": busiest_nz})


def replay_profile(step, k: int) -> tuple:
    """(launches, ms a step): one call of ``step`` (K training steps) on
    the device, by kernel (torch.profiler's CUDA activity; a CUDA graph
    replay shows each of its kernel nodes). The launches count kernels
    A-D by name; the time goes to A, B, C, D's two kernels, D's library
    sort and the rest (the small torch ops), each per step."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    counts = {name: 0 for name in TRAIN_KERNELS.values()}
    groups = {"A": ("render_planes_kernel",), "B": ("env_accumulate_kernel",),
              "C": ("bwd_tables_kernel",),
              "D": ("env_runs_kernel", "texel_sums_kernel"),
              "D_sort": ("RadixSort", "fill_reverse_indices")}
    ms = dict.fromkeys([*groups, "other"], 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        for name in counts:
            if name in e.key:
                counts[name] += e.count
        group = next((g for g, names in groups.items()
                      if any(n in e.key for n in names)), "other")
        ms[group] += us / 1e3 / k
    return counts, ms


# kernels A-D by their CUDA function names (D's first kernel: the runs)
TRAIN_KERNELS = {"render_planes": "render_planes_kernel",
                 "env_accumulate": "env_accumulate_kernel",
                 "bwd_tables": "bwd_tables_kernel",
                 "env_backward": "env_runs_kernel"}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def phase_training(dev, scene, cam, tex, glass_cfg, gpu) -> dict:
    """Phase 8: the training path through the kernels, K = 16 steps a
    dispatch (one CUDA graph) and K = 1 (the per-step loop)."""
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
        grad_steps,
        bench_loss,
        default_bench_params,
        fwd_bwd_benchmark,
        make_grad_step_k,
    )
    from cpuperformanceraytracer_tpu_torch.diff.grad import (
        loss_and_grad,
        render_for_params,
        value_and_grad,
    )
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        adam_inverse_render,
        make_train_step,
        make_train_step_k,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import render_planes

    cfg = glass_cfg.replace(rng="counter", backend="cuda")
    kernels = (render_planes, env_accumulate, bwd_tables, env_backward)
    params = default_bench_params(scene, tex)
    loss_fn = bench_loss(cfg, scene, cam, tex)
    runs = {}
    for k in (STEPS_PER_DISPATCH, 1):
        # the main path's run, traced: kernel launches on the device
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            traced = fwd_bwd_benchmark(cfg, scene, cam, tex, steps=STEPS,
                                       steps_per_dispatch=k, spans=2)
            torch.cuda.synchronize()
        wrapper = {kern.__name__: kern.launches for kern in kernels}
        launches = {name: sum(e.count for e in prof.key_averages()
                              if fn in e.key)
                    for name, fn in TRAIN_KERNELS.items()}
        # a step a call of the warmup, the untimed span (half the timed
        # steps) and the timed spans; K > 1: the capture's warm-up run
        # (K steps, outside the graph); A and B once more for the target
        steps_run = WARMUP_CALLS * k + traced["steps_timed"] * 3 // 2
        outside = k + 1 if k > 1 else steps_run + 1
        expect = {"render_planes": steps_run + (k if k > 1 else 0) + 1}
        expect["env_accumulate"] = expect["render_planes"]
        expect["bwd_tables"] = expect["env_backward"] = expect[
            "render_planes"] - 1
        expect_wrapper = {"render_planes": outside, "env_accumulate": outside,
                          "bwd_tables": outside - 1, "env_backward": outside - 1}
        if launches != expect or wrapper != expect_wrapper:
            raise AssertionError(
                f"training K={k}: device launches {launches}, expected "
                f"{expect}; wrapper counts {wrapper}, expected "
                f"{expect_wrapper}")
        del prof
        r = fwd_bwd_benchmark(cfg, scene, cam, tex, steps=STEPS,
                              steps_per_dispatch=k, spans=2)
        if not (r["grads_finite"] and traced["grads_finite"]) or r[
                "steps_per_dispatch"] != k:
            raise AssertionError(f"training K={k}: {r}")
        if k > 1:
            step_k = make_grad_step_k(loss_fn, k)

            def call():
                step_k(params, 1)
        else:
            def call():
                value_and_grad(loss_fn, params, 1)
        call()
        per_call = r["ms_per_step"] * k
        # windows of 2 calls; the sleep covers four times the host clock's
        # time for them (~2 GHz)
        n = 2
        busy_ms = device_frame_ms(call, n, int(4 * n * per_call * 1e-3 * 2.0e9),
                                  windows=8) / k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        enqueue_ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        runs[k] = dict(r, launches=launches, wrapper_launches=wrapper,
                       traced_ms_per_step=traced["ms_per_step"],
                       device_busy_ms_per_step=busy_ms,
                       idle_share=1.0 - busy_ms / r["ms_per_step"],
                       host_enqueue_ms_per_dispatch=enqueue_ms)
        phase("training bench", f"K={k}: {r['ms_per_step']:.4f} ms/step; "
              f"{r['Mrays_per_s']:.1f} Mrays/s; spans {r['span_ms']} ms; "
              f"device busy {busy_ms:.4f} ms/step; idle share "
              f"{runs[k]['idle_share']:.4f}; host enqueue {enqueue_ms:.4f} "
              f"ms/dispatch; traced run {traced['ms_per_step']:.4f} ms/step, "
              f"device launches {launches} ({steps_run} steps), wrapper "
              f"counts {wrapper}")

    # one replay of the K-step graph: K launches of each of kernels A-D
    step_k = make_grad_step_k(loss_fn, STEPS_PER_DISPATCH)
    got_sum, got_losses = step_k(params, 1)
    replay, replay_ms = replay_profile(lambda: step_k(params, 1),
                                       STEPS_PER_DISPATCH)
    want = {name: STEPS_PER_DISPATCH for name in replay}
    if {n: replay[n] for n in want} != want:
        raise AssertionError(f"one replay launched {replay}, expected {want}")
    want_sum, want_losses = grad_steps(
        loss_fn, params, [1 + i for i in range(STEPS_PER_DISPATCH)])
    torch.cuda.synchronize()
    if not (bits_equal(got_losses, want_losses) and all(
            bits_equal(got_sum[n], want_sum[n]) for n in params)):
        raise AssertionError("graphed grad_sum/losses differ from the "
                             "ungraphed steps")
    del got_sum, want_sum

    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    problem = InverseProblem(scene, cam, tex, cfg, target)

    def adam_copy():
        p = {n: v.detach().clone().requires_grad_() for n, v in params.items()}
        return p, torch.optim.Adam(list(p.values()), lr=0.01, capturable=True)

    pg, opt_g = adam_copy()
    pu, opt_u = adam_copy()
    lg = make_train_step_k(problem, opt_g, STEPS_PER_DISPATCH,
                           resample_frames=True)(pg, 1)
    plain = make_train_step(problem, opt_u, resample_frames=True)
    lu = torch.stack([plain(pu, 1 + i) for i in range(STEPS_PER_DISPATCH)])
    torch.cuda.synchronize()
    if not (bits_equal(lg, lu) and all(bits_equal(pg[n].detach(),
                                                   pu[n].detach())
                                       for n in params)):
        raise AssertionError("graphed Adam steps differ from ungraphed ones")
    del pg, pu, opt_g, opt_u

    loss_a, got = loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    loss_b, again = loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    if not (torch.equal(loss_a, loss_b) and all(
            bits_equal(got[n], again[n]) for n in params)):
        raise AssertionError("training: two steps on one frame differ")
    del again
    _, want = loss_and_grad(params, target, scene, cam, tex,
                            cfg.replace(backend="torch"), 1)
    rels = {n: rel_l2(got[n], want[n]) for n in params}
    if max(rels.values()) >= 2e-2:
        raise AssertionError(f"training gradients vs plain path: {rels}")
    del got, want

    # the same step with a cubemap env (six gradient_sky(256, 256) faces),
    # stochastic: kernels B and D take its tap
    cube = cubemap_texture(dev, 256)
    ccfg = cfg.replace(env_mode="cubemap")
    cparams = default_bench_params(scene, cube)
    with torch.no_grad():
        ctarget = render_for_params({}, scene, cam, cube, ccfg, 0)
    _, cgot = loss_and_grad(cparams, ctarget, scene, cam, cube, ccfg, 1)
    _, cwant = loss_and_grad(cparams, ctarget, scene, cam, cube,
                             ccfg.replace(backend="torch"), 1)
    crels = {n: rel_l2(cgot[n], cwant[n]) for n in cparams}
    if max(crels.values()) >= 2e-2 or not all(
            torch.isfinite(v).all() and v.norm() > 0 for v in cgot.values()):
        raise AssertionError(f"cubemap training gradients vs plain path: {crels}")
    del cgot, cwant

    # 8 Adam steps: K = 8, one CUDA graph (JAX's auto rule)
    m = scene.materials.albedo
    albedo = torch.stack([m.x, m.y, m.z], -1)
    _, losses = adam_inverse_render(problem, {"albedo": albedo + 0.05},
                                    steps=8, learning_rate=0.01)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"inverse: losses {losses}")
    g, u = runs[STEPS_PER_DISPATCH], runs[1]
    phase("training path", f"K={STEPS_PER_DISPATCH}: "
          f"{g['ms_per_step']:.4f} ms/step, device busy "
          f"{g['device_busy_ms_per_step']:.4f}, idle share "
          f"{g['idle_share']:.4f}, host enqueue "
          f"{g['host_enqueue_ms_per_dispatch']:.4f} ms/dispatch; K=1: "
          f"{u['ms_per_step']:.4f} ms/step, device busy "
          f"{u['device_busy_ms_per_step']:.4f}, idle share "
          f"{u['idle_share']:.4f}, host enqueue "
          f"{u['host_enqueue_ms_per_dispatch']:.4f} ms/dispatch (1280x720 "
          f"glass_spheres 8 bounces, counter RNG, env gradient_sky(512,256)); "
          f"one replay launched {replay}, device ms a step by kernel "
          + ", ".join(f"{n} {v:.4f}" for n, v in replay_ms.items())
          + f"; graphed grad_sum and losses "
          f"bit-equal to {STEPS_PER_DISPATCH} ungraphed steps; "
          f"{STEPS_PER_DISPATCH} graphed Adam steps bit-equal to ungraphed "
          f"capturable ones; two steps bit-equal; grads vs plain path "
          f"relative L2 " + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
          + "; cubemap step vs plain path "
          + ", ".join(f"{n} {v:.3e}" for n, v in crels.items())
          + f"; inverse losses {[round(x, 6) for x in losses]}; GPU {gpu}")
    summary = dict(k16=g, k1=u, replay_kernel_launches=replay,
                   replay_ms_per_step_by_kernel=replay_ms,
                   graphed_bit_equal=True, adam_graphed_bit_equal=True,
                   grad_rel_l2_vs_plain=rels, bit_equal_twice=True,
                   cubemap_grad_rel_l2_vs_plain=crels, inverse_losses=losses)
    return {"launches": g["launches"], "launches_k1": u["launches"],
            "summary": summary}


TEXTURED_FRAMES = 16            # timed textured_1080 frames (phase 12)
OUT_DIR = "build/chip_smoke"    # the PNG and the checkpoint (gitignored)


def cubemap_texture(dev, size: int):
    """Six gradient_sky(size, size) faces stacked: a cubemap fixture."""
    import numpy as np

    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    return texture_from_array(np.concatenate(
        [gradient_sky(size, size, seed=i) for i in range(6)]), dev)


def phase_kernel_e(dev, planes, cfg, tex) -> float:
    """Phase 9: kernel E vs its plain version; returns the max abs error
    where the taps agree."""
    from cpuperformanceraytracer_tpu_torch.kernels.env_gather import (
        env_lookup,
        env_lookup_reference,
        gather_texels,
        gather_texels_reference,
    )

    textures = {"equirect": tex, "cubemap": cubemap_texture(dev, 256)}
    n = cfg.width * cfg.height
    worst_share, err, notes = 1.0, 0.0, []
    for mode in ("equirect", "cubemap"):
        for sampling in ("stochastic", "nearest", "bilinear"):
            c = cfg.replace(env_mode=mode, env_sampling=sampling)
            taps = torch.empty((n, 4), dtype=torch.int64, device=dev)
            taps_w = torch.empty_like(taps)
            got = env_lookup(planes, textures[mode], c, taps_out=taps)
            want = env_lookup_reference(planes, textures[mode], c,
                                        taps_out=taps_w)
            torch.cuda.synchronize()
            same = (taps == taps_w).all(-1)
            share = same.double().mean().item()
            if share < 0.999:
                raise AssertionError(f"kernel E {mode} {sampling}: taps equal "
                                     f"on {share:.4%}")
            torch.testing.assert_close(
                got[same], want[same], rtol=1e-6, atol=0,
                msg=lambda m: f"kernel E {mode} {sampling}: {m}")
            err = max(err, (got[same] - want[same]).abs().max().item())
            worst_share = min(worst_share, share)
            notes.append(f"{mode}/{sampling} {share:.5%}")
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.int32, torch.int64):
        rows = torch.randint(-8, tex.height + 8, (n,), device=dev,
                             generator=gen, dtype=dtype)
        cols = torch.randint(-8, tex.width + 8, (n,), device=dev,
                             generator=gen, dtype=dtype)
        if not torch.equal(gather_texels(tex, rows, cols),
                           gather_texels_reference(tex, rows, cols)):
            raise AssertionError(f"gather_texels {dtype} differs from indexing")
    phase("kernel E", f"720p glass planes, taps equal on "
          + ", ".join(notes) + f"; rows rtol 1e-6 where equal (max abs err "
          f"{err:.3g}); gather_texels bit-equal (int32, int64)")
    return err


def phase_kernel_f(dev) -> float:
    """Phase 10: kernel F vs its plain version at 1920x1080."""
    from cpuperformanceraytracer_tpu_torch.kernels.combine import (
        combine_accumulate,
        combine_accumulate_reference,
    )

    h, w = 1080, 1920
    gen = torch.Generator(device=dev).manual_seed(3)
    err = 0.0
    for spp in (1, 16):
        planes = torch.rand((spp, 12, h, w), device=dev, generator=gen)
        e4 = torch.rand((spp, h * w, 4), device=dev, generator=gen) * 4.0
        acc = torch.rand((3, h, w), device=dev, generator=gen)
        args = ((e4[0], planes[0, 0:3], planes[0, 6:9]) if spp == 1
                else (e4, planes[:, 0:3], planes[:, 6:9]))
        got = combine_accumulate(*args, acc.clone(), 0.25)
        want = combine_accumulate_reference(*args, acc.clone(), 0.25)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                                   msg=lambda m: f"kernel F spp {spp}: {m}")
        err = max(err, (got - want).abs().max().item())
        del planes, e4
    phase("kernel F", f"1920x1080 spp 1 and 16 allclose rtol 1e-6 (max abs "
          f"err {err:.3g})")
    return err


def phase_kernel_g(dev, accum720) -> float:
    """Phase 11: kernel G vs its plain version, in f32 and in u8."""
    from cpuperformanceraytracer_tpu_torch.core.color import to_u8
    from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
    from cpuperformanceraytracer_tpu_torch.kernels.tonemap import (
        tonemap,
        tonemap_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(4)
    seeded = torch.rand((3, 1080, 1920), device=dev, generator=gen) * 8.0
    seeded[:, 0, :4] = torch.tensor([0.0, 1e-12, 1e-3, 50.0], device=dev)
    err, worst_eq, worst_d = 0.0, 1.0, 0
    for name, acc in (("seeded 1080p", seeded), ("main path 720p", accum720)):
        got, want = tonemap(acc, 1.0), tonemap_reference(acc, 1.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0,
                                   msg=lambda m: f"kernel G {name}: {m}")
        d = (to_u8(Vec3(*got)).int() - to_u8(Vec3(*want)).int()).abs()
        eq = (d == 0).double().mean().item()
        if eq < 0.9999 or d.max().item() > 1:
            raise AssertionError(f"kernel G {name}: u8 equal on {eq:.5%}, "
                                 f"max off {d.max().item()}")
        err = max(err, (got - want).abs().max().item())
        worst_eq, worst_d = min(worst_eq, eq), max(worst_d, d.max().item())
    phase("kernel G", f"f32 rtol 1e-5 (max abs err {err:.3g}); u8 equal on "
          f">= {worst_eq:.5%} of values, max off {worst_d}")
    return err


def phase_textured(dev, gpu) -> dict:
    """Phase 12: the textured multi-sample path through kernels A, E, F
    and the display through G; the timings of E, F and G at its shapes."""
    import os

    from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu_torch.kernels.combine import (
        combine_accumulate,
        combine_accumulate_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_gather import (
        env_lookup,
        env_lookup_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.tonemap import (
        tonemap,
        tonemap_reference,
    )
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.render.frame import frame_blend
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

    cfg = BENCH_CONFIGS["textured_1080"].replace(
        warmup_frames=WARMUP, num_frames=TEXTURED_FRAMES, backend="cuda")
    tex = texture_from_array(gradient_sky(2048, 1024), dev)
    scene, cam = scene_by_name(cfg.scene, device=dev)
    kernels = (render_planes, env_lookup, combine_accumulate, env_accumulate)
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam, silent=True)
    for k in kernels:
        k.launches = 0
    timer = r.run()
    launches = {k.__name__: k.launches for k in kernels}
    frames = WARMUP + TEXTURED_FRAMES
    expect = {"render_planes": cfg.spp * frames, "env_lookup": cfg.spp * frames,
              "combine_accumulate": frames, "env_accumulate": 0}
    if launches != expect:
        raise AssertionError(f"textured launches {launches}, expected {expect}")
    if not torch.isfinite(r.accum).all() or r.accum.mean().item() <= 0.0:
        raise AssertionError("textured path: accumulator not finite or zero")
    os.makedirs(OUT_DIR, exist_ok=True)
    tonemap.launches = 0
    r.write_image(os.path.join(OUT_DIR, "textured_1080.png"))
    if tonemap.launches != 1:
        raise AssertionError(f"image write launched G {tonemap.launches} times")
    launches["tonemap"] = tonemap.launches
    img_mean = float(r.image_u8().mean())

    offs = {}
    two = cfg.replace(num_frames=2, warmup_frames=0)
    checks = (("textured_1080", two, tex, 2),
              ("720p bilinear", two.replace(width=1280, height=720,
                                            env_sampling="bilinear"), tex, 1),
              ("720p cubemap nearest", two.replace(
                  width=1280, height=720, env_mode="cubemap",
                  env_sampling="nearest"), cubemap_texture(dev, 256), 1))
    for name, c, t, n in checks:
        a = OfflineRenderer(c, texture=t, scene=scene, camera=cam, silent=True)
        b = OfflineRenderer(c.replace(backend="torch"), texture=t, scene=scene,
                            camera=cam, device=dev, silent=True)
        for _ in range(n):
            a.step()
            b.step()
        offs[name] = max(robust(a.accum[ch], b.accum[ch],
                                f"{name} channel {ch}", 1e-2)
                         for ch in range(3))
        del a, b
    rays = cfg.width * cfg.height * cfg.spp
    mrays = timer.rays_per_second(rays) / 1e6
    busy_ms = device_frame_ms(OfflineRenderer(
        cfg, texture=tex, scene=scene, camera=cam, silent=True).step, 4)
    idle = 1.0 - busy_ms / timer.mean_ms

    # the kernels alone at this path's shapes: one frame's 16 samples
    one = cfg.replace(spp=1)
    tables = pack_tables(scene, cam, cfg, dev)
    n_px = cfg.width * cfg.height
    planes = torch.empty((cfg.spp, 12, cfg.height, cfg.width), device=dev)
    e4 = torch.empty((cfg.spp, n_px, 4), device=dev)
    taps = torch.empty((n_px, 4), dtype=torch.int64, device=dev)
    taps_s, taps_w = torch.empty_like(taps), torch.empty_like(taps)
    # kernel E vs its plain version at this path's shapes (1080p planes, a
    # 2048x1024 env): every sample of one frame, phase 9's rules
    share_e, err_e = 1.0, 0.0
    for s_ in range(cfg.spp):
        render_planes(tables, one, 3, sample0=s_, out=planes[s_])
        env_lookup(planes[s_], tex, cfg, out=e4[s_],
                   taps_out=taps if s_ == 0 else taps_s)
        want = env_lookup_reference(planes[s_], tex, cfg, taps_out=taps_w)
        same = ((taps if s_ == 0 else taps_s) == taps_w).all(-1)
        share = same.double().mean().item()
        if share < 0.999:
            raise AssertionError(f"kernel E textured_1080 sample {s_}: taps "
                                 f"equal on {share:.4%}")
        torch.testing.assert_close(
            e4[s_][same], want[same], rtol=1e-6, atol=0,
            msg=lambda m: f"kernel E textured_1080 sample {s_}: {m}")
        share_e = min(share_e, share)
        err_e = max(err_e, (e4[s_][same] - want[same]).abs().max().item())
        del want, same
    del taps_s, taps_w
    acc = r.accum.clone()
    ms_a = cuda_ms(lambda: render_planes(tables, one, 3, out=planes[0]), 20)
    ms_e = cuda_ms(lambda: env_lookup(planes[0], tex, cfg, out=e4[0]), 100)
    plain_ms_e = cuda_ms(lambda: env_lookup_reference(planes[0], tex, cfg), 5)
    table = torch.stack([tex.r, tex.g, tex.b, torch.zeros_like(tex.r)], -1)
    flat = taps[:, 0].contiguous()
    lib_ms_e = cuda_ms(lambda: table.index_select(0, flat), 100)
    args = (e4, planes[:, 0:3], planes[:, 6:9], acc, frame_blend(3))
    ms_f = cuda_ms(lambda: combine_accumulate(*args), 50)
    plain_ms_f = cuda_ms(lambda: combine_accumulate_reference(*args), 3)
    ms_g = cuda_ms(lambda: tonemap(acc), 200)
    held_g = device_ms(lambda: tonemap(acc), 200, dev)
    plain_ms_g = cuda_ms(lambda: tonemap_reference(acc), 20)
    texels = torch.unique(flat).numel()
    # E: 5 planes read, one RGBX row written, the texels it touches read
    bound_e = bound(n_px * (5 * 4 + 16) + 12 * texels, 40 * n_px)
    # F: per sample an RGBX row and 6 planes read; the accumulator read
    # and written
    bound_f = bound(n_px * (cfg.spp * (16 + 6 * 4) + 2 * 12),
                    n_px * (cfg.spp * 9 + 12))
    bound_g = bound(n_px * 2 * 12, n_px * 3 * 20)
    phase("textured path", f"{timer.mean_ms:.4f} ms/frame; {mrays:.1f} "
          f"Mrays/s (primary, textured_1080: 1920x1080 glass_spheres 16 spp "
          f"8 bounces, counter RNG, env gradient_sky(2048,1024)); launches "
          f"{launches}; image mean {img_mean:.2f}; vs plain path "
          + ", ".join(f"{k} {v:.5%} px off" for k, v in offs.items())
          + f"; device busy {busy_ms:.4f} ms/frame, idle share {idle:.4f}; "
          f"E vs plain on 16 samples: taps equal on >= {share_e:.5%}, rows "
          f"max abs err {err_e:.3g} where equal; "
          f"A {ms_a:.4f} ms a sample; E {ms_e:.4f} ms (plain {plain_ms_e:.3f}, index_select "
          f"{lib_ms_e:.4f}, bound {bound_e[0]:.4f}, {texels} texels), F "
          f"{ms_f:.4f} ms (plain {plain_ms_f:.3f}, bound {bound_f[0]:.4f}), "
          f"G {held_g:.4f} ms held full, {ms_g:.4f} back to back (plain "
          f"{plain_ms_g:.4f}, bound {bound_g[0]:.4f}); "
          f"GPU {gpu}")
    summary = dict(ms_per_frame=timer.mean_ms, Mrays_per_s=mrays,
                   device_busy_ms_per_frame=busy_ms, idle_share=idle,
                   frames=TEXTURED_FRAMES, warmup=WARMUP,
                   megakernel_ms_per_sample=ms_a,
                   px_off_vs_plain=offs, image_mean=img_mean)
    return dict(launches=launches, summary=summary,
                e=dict(ms=ms_e, plain_ms=plain_ms_e, library_ms=lib_ms_e,
                       bound=bound_e), err_e=err_e,
                f=dict(ms=ms_f, plain_ms=plain_ms_f, library_ms=None,
                       bound=bound_f),
                g=dict(ms=held_g, back_to_back_ms=ms_g, plain_ms=plain_ms_g,
                       library_ms=None, bound=bound_g))


def phase_checkpoint(dev) -> None:
    """Phase 13: 8 frames saved every 4, resumed for 4 more in a new
    renderer: bit-equal to 12 frames in one run."""
    import os

    from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    cfg = BENCH_CONFIGS["textured_1080"].replace(
        warmup_frames=0, num_frames=8, backend="cuda")
    tex = texture_from_array(gradient_sky(2048, 1024), dev)
    path = os.path.join(OUT_DIR, "textured_1080.npz")
    if os.path.exists(path):
        os.remove(path)
    OfflineRenderer(cfg, texture=tex, silent=True).run(path, 4)
    resumed = OfflineRenderer(cfg.replace(num_frames=4), texture=tex,
                              silent=True)
    resumed.resume(path)
    if resumed.frame != 8:
        raise AssertionError(f"resumed at frame {resumed.frame}, not 8")
    resumed.run()
    whole = OfflineRenderer(cfg.replace(num_frames=12), texture=tex,
                            silent=True)
    whole.run()
    if not torch.equal(resumed.accum, whole.accum):
        diff = (resumed.accum - whole.accum).abs().max().item()
        raise AssertionError(f"resumed run differs from one run by {diff}")
    phase("checkpoint", "textured_1080: 8 frames saved every 4 + 4 resumed "
          "in a new renderer == 12 frames in one run, bit for bit")


def phase_probes(dev, gpu) -> tuple:
    """Phase 14: the probe entry points with counted launches, then K6-K8
    against their plain versions; the four kernels' JSON rows. Times are
    device times with the stream held full (``device_ms``), except the
    plain K6 (7290 torch ops a call, timed back to back)."""
    from cpuperformanceraytracer_tpu_torch.probes import (
        gather_bench,
        overlap_probe,
        trace_probe,
    )
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

    def dms(fn, iters):
        return device_ms(fn, iters, dev)

    kernels = {"trace_dots": trace_probe.trace_dots,
               "texel_gather": gather_bench.texel_gather,
               "row_copy": overlap_probe.row_copy,
               "dsmem_gather": overlap_probe.dsmem_gather}
    for k in kernels.values():
        k.launches = 0
    t = trace_probe.run(dev)
    g = gather_bench.run(dev)
    o = overlap_probe.run(dev)
    launches = {name: k.launches for name, k in kernels.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"probe kernels not launched: {launches}")
    p1, p2, p3 = o["p1"], o["p2"], o["p3"]

    # K6: 9 segments of 54 dots of 8 features, then the acc chain (55 ops)
    x, B = t["x"], t["B"]
    n = x.shape[1] * x.shape[2]
    want = trace_probe.trace_dots_reference(x, B)
    got = trace_probe.trace_dots(x, B, "cuda_core")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                               msg=lambda m: f"K6 cuda_core vs plain: {m}")
    err_k6 = (got - want).abs().max().item()
    tc_err = trace_probe.max_rel_err(trace_probe.trace_dots(x, B, "tensor_core"),
                                     got)
    if not tc_err < 1e-4:
        raise AssertionError(f"K6 tensor_core vs cuda_core: max rel err {tc_err}")
    plain_k6 = cuda_ms(lambda: trace_probe.trace_dots_reference(x, B), 2, 1)
    chain = trace_probe.REPEAT * n * 55
    bound_cc = bound(n * 9 * 4, trace_probe.REPEAT * n * trace_probe.NCOL * 15 + chain)
    bound_tc = bound(n * 9 * 4, chain, 3 * trace_probe.REPEAT * n * 56 * 8 * 2)

    # K7: the race's entries, each layout bit-equal to the plain version
    planes, packed, flat = g["planes"], g["packed"], g["flat"]
    layouts = {"planar_1": (planes[:1], False), "planar_3": (planes, False),
               "packed": (packed, True)}
    k7 = {}
    for key, (table, pk) in layouts.items():
        out = gather_bench.texel_gather(table, flat, pk)
        if not torch.equal(out, gather_bench.texel_gather_reference(
                table, flat, pk)):
            raise AssertionError(f"K7 {key} differs from its plain version")
        k7[key] = dict(
            ms=dms(lambda: gather_bench.texel_gather(table, flat, pk), 100),
            plain_ms=dms(lambda: gather_bench.texel_gather_reference(
                table, flat, pk), 20),
            bound=bound(4 * (flat.numel() + out.numel() + table.numel()), 0))
    flat64 = flat.long()
    k7["planar_1"]["library_ms"] = dms(lambda: planes[0][flat64], 100)
    k7["packed"]["library_ms"] = dms(lambda: packed.index_select(0, flat64), 100)
    if not all(g["correct"].values()):
        raise AssertionError(f"gather race: {g['correct']}")

    # K8a: every mechanism, row and copy count bit-equal to the contract
    k8a = {}
    for (mech, row_bytes, copies), ms in p2["ms"].items():
        table = p2["table"][:, :row_bytes // 4].contiguous()
        idx = p2["idx"][:copies]
        out = overlap_probe.row_copy(table, idx, mech)
        if not torch.equal(out, overlap_probe.row_copy_reference(table, idx)):
            raise AssertionError(f"K8a {mech} {row_bytes} B x {copies} differs")
        k8a[f"{mech}_{row_bytes}B_{copies}"] = dict(
            ms=ms, ns_per_copy=ms * 1e6 / copies,
            bound=bound(copies * (4 + row_bytes) + out.numel() * 4, 0))
    table, idx = p2["table"], p2["idx"]
    last = idx[torch.arange(overlap_probe.SLOTS, device=dev)
               + idx.numel() - overlap_probe.SLOTS].long()
    if not torch.equal(table.index_select(0, last),
                       overlap_probe.row_copy(table, idx)):
        raise AssertionError("K8a: index_select of the last 8 rows differs")
    lib_k8a = dms(lambda: table.index_select(0, last), 100)
    plain_k8a = dms(lambda: overlap_probe.row_copy_reference(table, idx), 20)
    if not all(p2["correct"].values()):
        raise AssertionError(f"P2: {p2['correct']}")

    # K8b: both query counts bit-equal; the L2 gather (K7) beside
    tbl = p3["table"]
    k8b = {}
    for key, (rows, cols) in (("2048", p3["small"]), ("921600", p3["big"])):
        out = overlap_probe.dsmem_gather(tbl, rows, cols)
        if not torch.equal(out, overlap_probe.dsmem_gather_reference(
                tbl, rows, cols)):
            raise AssertionError(f"K8b at {key} queries differs")
        r64, c64 = rows.long(), cols.long()
        k8b[key] = dict(
            ms=p3["ms"]["16x128" if key == "2048" else key],
            plain_ms=dms(lambda: overlap_probe.dsmem_gather_reference(
                tbl, rows, cols), 20),
            library_ms=dms(lambda: tbl[r64, c64], 100),
            bound=bound(tbl.numel() * 4 + rows.numel() * 12, 0))
    if not all(p3["correct"].values()):
        raise AssertionError(f"P3: {p3['correct']}")

    phase("probes", f"launches {launches}; K6 cuda_core "
          f"{t['ms']['cuda_core']:.4f} ms (plain {plain_k6:.2f}, bound "
          f"{bound_cc[0]:.4f}, max abs err vs plain {err_k6:.3g}), tensor_core "
          f"{t['ms']['tensor_core']:.4f} ms (bound {bound_tc[0]:.4f}, max rel "
          f"err vs cuda_core {tc_err:.3e}); K7 " + ", ".join(
              f"{k} {v['ms']:.4f} ms" for k, v in k7.items())
          + f" (plane[flat] {k7['planar_1']['library_ms']:.4f}, index_select "
          f"(N,4) {k7['packed']['library_ms']:.4f}); K8a ns/copy at 4096: "
          + ", ".join(f"{k.rsplit('_', 1)[0]} {v['ns_per_copy']:.1f}"
                      for k, v in k8a.items() if k.endswith("_4096"))
          + f"; K8b {k8b['2048']['ms']:.4f} ms at 2048 q, "
          f"{k8b['921600']['ms']:.4f} at 921600 (L2 gather K7 "
          f"{p3['ms']['l2_921600']:.4f}); P1 trivial {p1['ms']['trivial']:.4f}"
          f" | kernel A {p1['ms']['kernel']:.4f} | gather "
          f"{p1['ms']['gather']:.4f} | together {p1['ms']['together']:.4f} "
          f"ms, overlap {p1['overlap']}; GPU {gpu}")

    def variants(d):
        return {k: dict({m: v for m, v in row.items() if m != "bound"},
                        bound_ms=row["bound"][0], bound_by=row["bound"][1])
                for k, row in d.items()}

    main_k8a = k8a["tma_512B_4096"]
    return [
        dict(name="trace_dots",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/trace_dots.cu",
             replaces="scripts/mxu_trace_probe.py:77",
             launches=launches["trace_dots"], max_abs_err=err_k6,
             ms=t["ms"]["cuda_core"], plain_ms=plain_k6, bound=bound_cc,
             library_ms=None, launches_by_path={}, variants=variants({
                 "cuda_core": dict(ms=t["ms"]["cuda_core"], bound=bound_cc),
                 "tensor_core": dict(ms=t["ms"]["tensor_core"], bound=bound_tc,
                                     max_rel_err_vs_cuda_core=tc_err)})),
        dict(name="texel_gather",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/texel_gather.cu",
             replaces="scripts/gather_bench.py:85",
             launches=launches["texel_gather"], max_abs_err=0.0,
             ms=k7["planar_1"]["ms"], plain_ms=k7["planar_1"]["plain_ms"],
             bound=k7["planar_1"]["bound"],
             library_ms=k7["planar_1"]["library_ms"], launches_by_path={},
             variants=variants(k7)),
        dict(name="row_copy",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/row_copy.cu",
             replaces="scripts/overlap_probe.py:159",
             launches=launches["row_copy"], max_abs_err=0.0,
             ms=main_k8a["ms"], plain_ms=plain_k8a, bound=main_k8a["bound"],
             library_ms=lib_k8a, launches_by_path={}, variants=variants(k8a)),
        dict(name="dsmem_gather",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/dsmem_gather.cu",
             replaces="scripts/overlap_probe.py:199",
             launches=launches["dsmem_gather"], max_abs_err=0.0,
             ms=k8b["2048"]["ms"], plain_ms=k8b["2048"]["plain_ms"],
             bound=k8b["2048"]["bound"], library_ms=k8b["2048"]["library_ms"],
             launches_by_path={}, variants=variants(k8b)),
    ], dict(p1=p1["ms"], p1_overlap=p1["overlap"],
            p1_gather_queries=p1["queries"])


ORACLE_FRAMES = 4              # timed oracle frames at 720p (phase 15)


def phase_oracle(dev, scene, cam, tex, glass_cfg, gpu) -> dict:
    """Phase 15: the oracle integrator (backend "oracle") on the card."""
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
        bench_loss,
        default_bench_params,
    )
    from cpuperformanceraytracer_tpu_torch.diff.grad import (
        image_loss,
        value_and_grad,
    )
    from cpuperformanceraytracer_tpu_torch.diff.path_replay import (
        render_for_params_replay,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
    )
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.render.integrator import render_frame
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    # the forward workload through the oracle, against the kernel route
    ocfg = glass_cfg.replace(backend="oracle", num_frames=ORACLE_FRAMES,
                             warmup_frames=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    oracle = OfflineRenderer(ocfg, texture=tex, scene=scene, camera=cam,
                             device=dev, silent=True)
    timer = oracle.run()
    frame_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    kernel = OfflineRenderer(glass_cfg.replace(num_frames=ORACLE_FRAMES,
                                               warmup_frames=0),
                             texture=tex, scene=scene, camera=cam, silent=True)
    kernel.run()
    if not torch.isfinite(oracle.accum).all():
        raise AssertionError("oracle frame not finite")
    off = max(robust(oracle.accum[c], kernel.accum[c],
                     f"oracle vs kernel route channel {c}", 1e-2)
              for c in range(3))

    # a diffuse frame strictly: the cornell box, counter RNG, no env
    dcfg = RenderConfig(width=256, height=64, bounces=2, scene="cornell_box",
                        env_mode="none", rng="counter", backend="oracle")
    dscene, dcam = scene_by_name("cornell_box", device=dev)
    got = render_frame(dscene, dcam, None, dcfg, 3)
    # without an env map kernel A adds the ambient itself: r, g, b are the
    # colour
    want = render_planes(pack_tables(dscene, dcam, dcfg, dev), dcfg, 3)[0:3]
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    diffuse_err = (got - want).abs().max().item()

    # path replay vs plain autograd through the oracle, with peak memory
    rcfg = RenderConfig(width=320, height=180, bounces=8, rng="counter",
                        env_mode="equirect", env_sampling="bilinear",
                        backend="oracle")
    params = default_bench_params(scene, tex)
    plain_loss = bench_loss(rcfg, scene, cam, tex)
    with torch.no_grad():
        target = render_frame(scene, cam, tex, rcfg, 0)

    def replay_loss(p, frame):
        return image_loss(render_for_params_replay(p, scene, cam, tex, rcfg,
                                                   frame), target)

    out, peak_gib, secs = {}, {}, {}
    for name, fn in (("plain", plain_loss), ("replay", replay_loss)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[name] = value_and_grad(fn, params, 1)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        peak_gib[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    (lp, gp), (lr, gr) = out["plain"], out["replay"]
    torch.testing.assert_close(lr, lp, rtol=1e-4, atol=1e-7)
    for n in params:
        if not gp[n].abs().max() > 0:
            raise AssertionError(f"path replay: plain {n} gradient is zero")
        torch.testing.assert_close(gr[n], gp[n], rtol=1e-4, atol=1e-7)
    phase("oracle", f"720p glass 8 bounces (wang, env gradient_sky(512,256)) "
          f"{timer.mean_ms:.2f} ms/frame over {ORACLE_FRAMES} frames, peak "
          f"{frame_peak:.2f} GiB; vs kernel route {off:.5%} px off; cornell "
          f"256x64 vs kernel A route max abs err {diffuse_err:.3g}; path "
          f"replay 320x180 8 bounces bilinear: grads equal plain (rtol "
          f"1e-4), peak above the inputs plain {peak_gib['plain']:.3f} GiB "
          f"({secs['plain']:.2f} s), replay {peak_gib['replay']:.3f} GiB "
          f"({secs['replay']:.2f} s); GPU {gpu}")
    return dict(ms_per_frame=timer.mean_ms, frames=ORACLE_FRAMES,
                frame_peak_gib=frame_peak, px_off_vs_kernel_route=off,
                diffuse_max_abs_err=diffuse_err,
                replay_peak_gib=peak_gib["replay"],
                plain_peak_gib=peak_gib["plain"], replay_s=secs["replay"],
                plain_s=secs["plain"])


SHARDED_STEPS = 5              # timed sharded training steps (phase 16)
SCALING_FRAMES = 64            # timed frames a world (phase 16)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_rank(cfg, params, target, steps: int, device: str) -> dict:
    """Phase 16: one rank of a gloo world of 2 on the one card (px = 2;
    then px = 1 x spp = 2): the frames, two training steps, the launches
    of kernels A-D over them, and the step's and the gradient
    all-reduce's times."""
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import render_planes
    from cpuperformanceraytracer_tpu_torch.parallel import shard
    from cpuperformanceraytracer_tpu_torch.parallel.mesh import make_mesh
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    dev = torch.device(device)
    scene, cam = scene_by_name(cfg.scene, device=dev)
    tex = texture_from_array(gradient_sky(512, 256), dev)
    kernels = (render_planes, env_accumulate, bwd_tables, env_backward)
    for k in kernels:
        k.launches = 0
    mesh = make_mesh((2, 1), device=dev)
    spp_mesh = make_mesh((1, 2), device=dev)
    frames = {rng: shard.sharded_render_frame(scene, cam, tex,
                                              cfg.replace(rng=rng), 3, mesh)
              for rng in ("wang", "counter")}
    frames["spp2"] = shard.sharded_render_frame(
        scene, cam, tex, cfg.replace(rng="counter", spp=2), 3, spp_mesh)
    tcfg = cfg.replace(rng="counter")
    p = {k: v.to(dev) for k, v in params.items()}
    tgt = target.to(dev)

    def step():
        return shard.sharded_loss_and_grad(p, tgt, scene, cam, tex, tcfg, 1,
                                           mesh)

    shard.comm_elements = 0
    loss, grads = step()
    elements = shard.comm_elements
    loss2, grads2 = step()
    sync(dev)
    launches = {k.__name__: k.launches for k in kernels}
    twice = bool(torch.equal(loss, loss2) and all(
        bits_equal(grads[k], grads2[k]) for k in grads))
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync(dev)
    ms_step = (time.perf_counter() - t0) / steps * 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        shard.allreduce_grads(grads, mesh)
    sync(dev)
    ms_allreduce = (time.perf_counter() - t0) / steps * 1e3
    return dict(frames={k: v.cpu() for k, v in frames.items()},
                loss=loss.cpu(), grads={k: g.cpu() for k, g in grads.items()},
                bit_equal_twice=twice, elements=elements, launches=launches,
                ms_step=ms_step, ms_grad_allreduce=ms_allreduce,
                grad_elements=sum(g.numel() for g in grads.values()))


def native_and_trace(dev, scene, cam, tex, cfg) -> None:
    """Phase 16, first: the native codec (built here) against the numpy
    path, and one forward frame under the profiler, whose trace names
    kernel A."""
    import os

    from cpuperformanceraytracer_tpu_torch.io import image, native
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.texture import hdr
    from cpuperformanceraytracer_tpu_torch.utils.profiling import TRACE_FILE, trace

    subprocess.run(["make", "-C", str(native.LIB_PATH.parent)], check=True,
                   capture_output=True, timeout=120)
    native._TRIED = False
    if native.get_lib() is None:
        raise AssertionError("native/librgbe.so did not load")
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "native")
    rs = torch.Generator().manual_seed(7)
    img = (torch.rand((9, 33, 3), generator=rs) * 4.0).numpy()
    hdr.write_hdr(path + ".hdr", img)
    if not (hdr.read_hdr_numpy(path + ".hdr")
            == native.read_hdr_native(path + ".hdr")).all():
        raise AssertionError("native HDR decode differs from the numpy path")
    u8 = (torch.rand((11, 22, 3), generator=rs) * 255).to(torch.uint8).numpy()
    image.write_bmp_numpy(path + "_numpy.bmp", u8)
    if not native.write_bmp_native(path + ".bmp", u8) or open(
            path + "_numpy.bmp", "rb").read() != open(path + ".bmp", "rb").read():
        raise AssertionError("native BMP encode differs from the numpy path")
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam,
                        device=dev, silent=True)
    r.step()
    with trace(os.path.join(OUT_DIR, "trace")) as d:
        r.step()
    with open(os.path.join(d, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = sorted({str(e.get("name"))[:48] for e in events
                    if e.get("cat") == "kernel"})
    if not any("render_planes_kernel" in n for n in names):
        raise AssertionError("the profiler's trace does not name kernel A; "
                             f"its kernels: {names}; {len(events)} events")


def window_times(dev, scene, cam, cfg) -> dict:
    """Phase 16: kernels A and C on the lower half of the frame's rows
    (bit-equal to those rows of a whole launch; C twice), and each held
    full on the window and on the whole frame."""
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
    )
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

    h = cfg.height // 2
    half = dict(row0=h, local_height=h)
    tables = pack_tables(scene, cam, cfg, dev)
    full_a = render_planes(tables, cfg, 0)
    win_a = render_planes(tables, cfg, 0, **half)
    ccfg = cfg.replace(rng="counter")
    gen = torch.Generator(device=dev).manual_seed(4)
    cot6 = torch.randn((6, cfg.height, cfg.width), device=dev, generator=gen)
    cwin = cot6[:, h:].contiguous()
    c1 = bwd_tables(tables, ccfg, 1, 0, cwin, **half)
    c2 = bwd_tables(tables, ccfg, 1, 0, cwin, **half)
    sync(dev)
    if not torch.equal(win_a, full_a[:, h:]):
        raise AssertionError("kernel A: the window differs from the whole "
                             "frame's rows")
    if not all(bits_equal(a, b) for a, b in zip(c1, c2)):
        raise AssertionError("kernel C: two window launches differ")
    return {"rows": h,
            "A_full": device_ms(lambda: render_planes(tables, cfg, 0), 20, dev),
            "A_window": device_ms(
                lambda: render_planes(tables, cfg, 0, **half), 20, dev),
            "C_full": device_ms(
                lambda: bwd_tables(tables, ccfg, 1, 0, cot6), 20, dev),
            "C_window": device_ms(
                lambda: bwd_tables(tables, ccfg, 1, 0, cwin, **half), 20, dev)}


def worlds(dev, scene, cam, tex, cfg) -> dict:
    """Phase 16: a world of 1 (no process group), a gloo world of 2 ranks
    on the one card against the unsharded kernel route, and the scaling
    harness's worlds of 1 and 2."""
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import default_bench_params
    from cpuperformanceraytracer_tpu_torch.diff.grad import (
        loss_and_grad,
        render_for_params,
    )
    from cpuperformanceraytracer_tpu_torch.parallel import budget, shard
    from cpuperformanceraytracer_tpu_torch.parallel.mesh import (
        make_mesh,
        spawn_world,
    )
    from cpuperformanceraytracer_tpu_torch.parallel.scaling import measure_scaling
    from cpuperformanceraytracer_tpu_torch.render.frame import make_frame_fn

    def unsharded(c):
        return make_frame_fn(c, scene, cam, dev)(
            tex, 3, torch.zeros((3, c.height, c.width), device=dev), 1.0)

    secs, t_start = {}, time.perf_counter()
    one = shard.sharded_render_frame(scene, cam, tex, cfg, 3,
                                     make_mesh((1, 1), device=dev))
    if not torch.equal(one, unsharded(cfg)):
        raise AssertionError("a world of 1 differs from the unsharded frame")

    tcfg = cfg.replace(rng="counter")
    params = default_bench_params(scene, tex)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, tcfg, 0)
    loss, grads = loss_and_grad(params, target, scene, cam, tex, tcfg, 1)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(SHARDED_STEPS):
        loss_and_grad(params, target, scene, cam, tex, tcfg, 1)
    sync(dev)
    ms_unsharded = (time.perf_counter() - t0) / SHARDED_STEPS * 1e3
    t0 = time.perf_counter()
    secs["references"] = t0 - t_start
    ranks = spawn_world(sharded_rank, 2, (
        cfg, {k: v.cpu() for k, v in params.items()}, target.cpu(),
        SHARDED_STEPS, dev.type), backend="gloo", timeout=300)
    secs["world_of_2"] = time.perf_counter() - t0
    want = {rng: unsharded(cfg.replace(rng=rng)).cpu()
            for rng in ("wang", "counter")}
    want_spp = unsharded(cfg.replace(rng="counter", spp=2)).cpu()
    n_elements = budget.training_step_comm_elements(
        cfg.height, cfg.width, 2, 1, [v.numel() for v in params.values()])
    rel, spp_err = {}, 0.0
    for i, rk in enumerate(ranks):
        for rng in ("wang", "counter"):
            if not torch.equal(rk["frames"][rng], want[rng]):
                raise AssertionError(f"rank {i}: the px-sharded {rng} frame "
                                     "differs from the unsharded one")
        spp_err = max(spp_err, (rk["frames"]["spp2"] - want_spp).abs().max().item())
        if spp_err > 1e-5:
            raise AssertionError(f"rank {i}: px 1 x spp 2 off by {spp_err}")
        if abs(rk["loss"].item() - loss.item()) > 1e-5 * abs(loss.item()):
            raise AssertionError(f"rank {i}: loss {rk['loss'].item()} vs "
                                 f"{loss.item()}")
        for k, g in grads.items():
            rel[k] = max(rel.get(k, 0.0), rel_l2(rk["grads"][k], g.cpu()))
        if max(rel.values()) >= 1e-5:
            raise AssertionError(f"rank {i}: gradients relative L2 {rel}")
        if not rk["bit_equal_twice"]:
            raise AssertionError(f"rank {i}: two sharded steps differ")
        if rk["elements"] != n_elements:
            raise AssertionError(f"rank {i}: {rk['elements']} elements "
                                 f"all-reduced, the budget says {n_elements}")
    launches = {k: sum(rk["launches"][k] for rk in ranks)
                for k in ranks[0]["launches"]}
    if min(launches.values()) == 0:
        raise AssertionError(f"sharded path launches {launches}")
    t0 = time.perf_counter()
    pts = measure_scaling(scene, cam, tex, cfg, device_counts=[1, 2],
                          frames=SCALING_FRAMES, backend="gloo", timeout=300)
    secs["scaling"] = time.perf_counter() - t0
    return dict(seconds=secs, spp2_max_abs_err=spp_err, loss=ranks[0]["loss"].item(),
                loss_unsharded=loss.item(), grads_rel_l2=rel,
                comm_elements=n_elements,
                ms_per_step=[rk["ms_step"] for rk in ranks],
                ms_per_step_unsharded_k1=ms_unsharded,
                ms_grad_allreduce=[rk["ms_grad_allreduce"] for rk in ranks],
                grad_allreduce_bytes=4 * ranks[0]["grad_elements"],
                launches=launches, scaling=[vars(p) for p in pts])


def phase_parallel(dev, scene, cam, tex, cfg, gpu) -> dict:
    """Phase 16: kernels A and C on a row window; the parallel layer. (Its
    first part, the native codec and the profiler trace, runs after phase
    5: in a process where phases 6-15 had run, a CPU + CUDA profile of a
    frame recorded no kernel on the H100 machine.)"""
    t0 = time.perf_counter()
    win = window_times(dev, scene, cam, cfg)
    t1 = time.perf_counter()
    w = worlds(dev, scene, cam, tex, cfg)
    secs = time.perf_counter() - t0
    w["seconds"]["windows"] = t1 - t0
    phase("parallel", f"held full, whole frame / {win['rows']}-row window: A "
          f"{win['A_full']:.4f} / {win['A_window']:.4f} ms (window = the "
          f"frame's rows), C {win['C_full']:.4f} / {win['C_window']:.4f} ms "
          f"(window bit-equal twice); world of 1 bit-equal; gloo world of 2 "
          f"on one card: frames wang + counter bit-equal, px 1 x spp 2 max "
          f"abs err {w['spp2_max_abs_err']:.3g}, loss {w['loss']:.7g} vs "
          f"{w['loss_unsharded']:.7g}, grads rel L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in w["grads_rel_l2"].items())
          + f", two steps bit-equal, {w['comm_elements']} elements = budget; "
          f"ms/step {[round(x, 4) for x in w['ms_per_step']]} (unsharded K=1 "
          f"{w['ms_per_step_unsharded_k1']:.4f}); grad all-reduce "
          f"{[round(x, 4) for x in w['ms_grad_allreduce']]} ms for "
          f"{w['grad_allreduce_bytes']} B; launches {w['launches']}; scaling "
          + ", ".join(f"{p['devices']}: {p['ms_per_frame']:.4f} ms/frame eff "
                      f"{p['efficiency']:.3f}" for p in w["scaling"])
          + f"; {secs:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in w["seconds"].items())
          + f"); GPU {gpu}")
    return dict(window_ms=win, world2=w, seconds=secs)


def phase_held_times(dev, planes, idx, tex, cfg, accum) -> dict:
    """Phase 14, last: small kernels timed back to back and held full."""
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
    from cpuperformanceraytracer_tpu_torch.kernels.env_gather import env_lookup
    from cpuperformanceraytracer_tpu_torch.kernels.tonemap import tonemap
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((3,) + tuple(idx.shape), device=dev, generator=gen)
    mt = planes[6:9]
    vals = (g * mt).reshape(3, -1).t().contiguous()
    scatter = torch.zeros((tex.width * tex.height, 3), device=dev)
    flat, acc = idx.reshape(-1), accum.clone()
    e4 = torch.empty((idx.numel(), 4), device=dev)
    calls = {"env_accumulate": lambda: env_accumulate(planes, tex, cfg, acc, 0.5),
             "env_backward": lambda: env_backward(g, idx, mt, tex),
             "index_add_": lambda: scatter.index_add_(0, flat, vals),
             "env_lookup": lambda: env_lookup(planes, tex, cfg, out=e4),
             "tonemap": lambda: tonemap(accum)}
    out = {k: dict(back_to_back_ms=cuda_ms(fn, 100),
                   held_ms=device_ms(fn, 40 if k == "env_backward" else 100, dev))
           for k, fn in calls.items()}
    phase("held stream", "720p, ms back to back / held full: " + ", ".join(
        f"{k} {v['back_to_back_ms']:.4f} / {v['held_ms']:.4f}"
        for k, v in out.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.kernels import _build
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
        env_accumulate,
        env_accumulate_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        PLANE_NAMES,
        pack_tables,
        plane_mismatch,
        render_planes,
        render_planes_reference,
        resident_blocks,
    )
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.render.frame import frame_blend
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    dev = torch.device("cuda")
    gpu = gpu_line()
    phase("device", f"{torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; nvidia-smi: {gpu}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # both libraries at once, one nvcc per source
    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(_build.build, (_build.RENDER, _build.PROBES)))
    for b in builds:
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{b.path.name} in {b.seconds:.1f} s; " + " | ".join(ptxas))
    _build.load_library(_build.RENDER)
    _build.load_library(_build.PROBES)

    # ---- phase 3: kernel A vs plain on the card --------------------------
    max_err_a = 0.0
    for rng in ("wang", "counter"):
        cfg = RenderConfig(width=256, height=64, bounces=2, spp=2,
                           scene="cornell_box", env_mode="none", rng=rng)
        tables = pack_tables(*scene_by_name("cornell_box", device=dev), cfg, dev)
        got = render_planes(tables, cfg, 3)
        want = render_planes_reference(tables, cfg, 3)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        max_err_a = max(max_err_a, (got - want).abs().max().item())
    # bench.py's env texture where the reference HDR is absent
    tex = texture_from_array(gradient_sky(512, 256), dev)
    cfg = RenderConfig(width=1280, height=720, bounces=8, spp=1,
                       scene="glass_spheres", env_mode="equirect",
                       env_sampling="stochastic", rng="wang",
                       warmup_frames=WARMUP, num_frames=FRAMES,
                       backend="cuda")
    scene, cam = scene_by_name(cfg.scene, device=dev)
    tables = pack_tables(scene, cam, cfg, dev)
    planes = render_planes(tables, cfg, 0)
    live_a, masks_a = [], []
    planes_ref = render_planes_reference(tables, cfg, 0, live_segments=live_a,
                                         live_masks=masks_a)
    torch.cuda.synchronize()
    for c in (0, 1, 2, 6, 7, 8):
        robust(planes[c], planes_ref[c], f"kernel A {PLANE_NAMES[c]}", 1e-3)
    off = plane_mismatch(planes, planes_ref)
    worst = max(off, key=off.get)
    if off[worst] >= 1e-3:
        raise AssertionError(f"kernel A planes: {off}")
    glass_err = (planes[:3] - planes_ref[:3]).abs().max().item()
    ms_a = cuda_ms(lambda: render_planes(tables, cfg, 0), 20)
    plain_ms_a = cuda_ms(lambda: render_planes_reference(tables, cfg, 0), 3, 1)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    render_planes(tables, cfg, 0, lane_stats=stats)
    util_a = stats[0].item() / stats[1].item()
    util_pixel = lane_utilisation(masks_a, cfg.width)
    del masks_a
    per_sm, sms = resident_blocks(tables)
    regs_a = ptxas_of(builds[0].log, "render_planes_kernel")
    phase("kernel A", f"cornell strict ok (max abs err {max_err_a:.3g}); "
          f"glass 1280x720 robust ok on 12 planes (worst {worst} "
          f"{off[worst]:.5%} px off; missed flags differ on "
          f"{off['missed']:.5%}; rgb max abs err {glass_err:.3g}); "
          f"{ms_a:.3f} ms vs plain {plain_ms_a:.3f} ms; lane utilisation "
          f"{util_a:.4f} (one thread per pixel: {util_pixel:.4f}); "
          f"{per_sm} blocks per SM x {sms} SMs; ptxas: {regs_a}")

    # ---- phase 4: kernel B vs plain on the same planes ------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    accum0 = torch.rand((3, 720, 1280), device=dev, generator=gen) * 3.0
    blend = frame_blend(3)
    got, want = accum0.clone(), accum0.clone()
    gi = torch.empty((720, 1280), dtype=torch.int64, device=dev)
    wi = torch.empty_like(gi)
    env_accumulate(planes, tex, cfg, got, blend, index_out=gi)
    env_accumulate_reference(planes, tex, cfg, want, blend, index_out=wi)
    torch.cuda.synchronize()
    same = gi == wi
    same_share = same.double().mean().item()
    if same_share < 0.999:
        raise AssertionError(f"kernel B: indices equal on {same_share:.4%}")
    torch.testing.assert_close(got[:, same], want[:, same], rtol=1e-5, atol=0)
    err_b = (got[:, same] - want[:, same]).abs().max().item()
    # the chain: kernel A's planes through kernel B vs the plain chain
    chain_ref = accum0.clone()
    env_accumulate_reference(planes_ref, tex, cfg, chain_ref, blend)
    chain_off = max(robust(got[c], chain_ref[c], f"chain A->B channel {c}",
                           1e-3) for c in range(3))
    scratch = accum0.clone()
    ms_b = cuda_ms(lambda: env_accumulate(planes, tex, cfg, scratch, blend), 200)
    plain_ms_b = cuda_ms(
        lambda: env_accumulate_reference(planes, tex, cfg, scratch, blend), 20)
    phase("kernel B", f"indices equal on {same_share:.5%}; accum allclose "
          f"(max abs err {err_b:.3g}); chain A->B vs plain chain "
          f"{chain_off:.5%} px off; {ms_b:.4f} ms vs plain "
          f"{plain_ms_b:.4f} ms")

    # ---- phase 5: the main path -----------------------------------------
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam, silent=True)
    render_planes.launches = 0
    env_accumulate.launches = 0
    timer = r.run()
    launches = {"render_planes": render_planes.launches,
                "env_accumulate": env_accumulate.launches}
    expect = WARMUP + FRAMES
    if set(launches.values()) != {expect}:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    img = r.image_u8()
    accum = r.accum
    if img.shape != (720, 1280, 3) or not torch.isfinite(accum).all() \
            or accum.mean().item() <= 0.0:
        raise AssertionError(f"bad image: shape {img.shape}, accum mean "
                             f"{accum.mean().item()}")
    plain = OfflineRenderer(cfg.replace(backend="torch"), texture=tex,
                            scene=scene, camera=cam, device=dev, silent=True)
    for _ in range(FRAMES):
        plain.step()
    main_off = max(robust(accum[c], plain.accum[c], f"main path channel {c}",
                          1e-2) for c in range(3))
    rays = cfg.width * cfg.height * cfg.spp
    mrays = timer.rays_per_second(rays) / 1e6
    busy_ms = device_frame_ms(
        OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam,
                        silent=True).step, FRAMES)
    idle = 1.0 - busy_ms / timer.mean_ms
    phase("main path", f"{timer.mean_ms:.4f} ms/frame; {mrays:.1f} Mrays/s "
          f"(primary, 1280x720 glass_spheres 8 bounces, env "
          f"gradient_sky(512,256)); "
          f"launches {launches}; image mean {img.mean():.2f}; accum vs "
          f"plain path {main_off:.5%} px off; device busy "
          f"{busy_ms:.4f} ms/frame, idle share {idle:.4f}; GPU {gpu}")

    # ---- phase 16, first part: the native codec, a profiler trace --------
    t0 = time.perf_counter()
    native_and_trace(dev, scene, cam, tex, cfg)
    phase("parallel", f"native codec = numpy path (make -C native); a "
          f"profiler trace of one forward frame names kernel A "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phases 6-8 --------------------------------------------------------
    c = phase_kernel_c(dev, tables, cfg, builds[0].log)
    d = phase_kernel_d(dev, planes, gi, tex)
    t = phase_training(dev, scene, cam, tex, cfg, gpu)

    # ---- phases 9-13: the textured multi-sample path ---------------------
    err_e = phase_kernel_e(dev, planes, cfg, tex)
    err_f = phase_kernel_f(dev)
    err_g = phase_kernel_g(dev, accum)
    x = phase_textured(dev, gpu)
    phase_checkpoint(dev)

    # ---- phase 14: the probes --------------------------------------------
    probe_rows, probes = phase_probes(dev, gpu)
    probes["held_stream_720p"] = phase_held_times(dev, planes, gi, tex, cfg,
                                                  accum)

    # ---- phase 15: the oracle integrator ----------------------------------
    o = phase_oracle(dev, scene, cam, tex, cfg, gpu)

    # ---- phase 16: the parallel layer, windows, native codec, trace -------
    par = phase_parallel(dev, scene, cam, tex, cfg, gpu)

    # ---- the kernels' numbers ---------------------------------------------
    n_px = cfg.width * cfg.height
    tex_bytes = 3 * 4 * tex.width * tex.height
    flops_a = sum(live_a) * segment_flops(tables) + n_px * FLOPS_CAMERA
    bound_a = bound(12 * 4 * n_px, flops_a)
    # kernel B as timed: 11 planes read, the accumulator read and written,
    # the texture read once
    bound_b = bound((11 + 6) * 4 * n_px + tex_bytes, 10 * n_px)
    rows = [
        dict(name="megakernel",
             source="cpuperformanceraytracer_tpu_torch/csrc/megakernel.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/megakernel.py:251",
             launches=launches["render_planes"], max_abs_err=glass_err,
             ms=ms_a, plain_ms=plain_ms_a, bound=bound_a, library_ms=None,
             launches_by_path={"forward": launches["render_planes"],
                               "training": t["launches"]["render_planes"],
                               "training_k1": t["launches_k1"]["render_planes"],
                               "sharded_2_ranks": par["world2"]["launches"]["render_planes"]},
             window={"row0": 360, "local_height": 360,
                     "held_ms": par["window_ms"]["A_window"],
                     "full_held_ms": par["window_ms"]["A_full"]},
             live_segments=sum(live_a), lane_utilisation=util_a,
             lane_utilisation_one_thread_per_pixel=util_pixel,
             resident_blocks_per_sm=per_sm, ptxas=regs_a),
        dict(name="env_accumulate",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_accumulate.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/megakernel.py:1162",
             launches=launches["env_accumulate"], max_abs_err=err_b,
             ms=ms_b, plain_ms=plain_ms_b, bound=bound_b, library_ms=None,
             launches_by_path={"forward": launches["env_accumulate"],
                               "training": t["launches"]["env_accumulate"],
                               "training_k1": t["launches_k1"]["env_accumulate"],
                               "sharded_2_ranks": par["world2"]["launches"]["env_accumulate"]}),
        dict(name="bwd_tables",
             source="cpuperformanceraytracer_tpu_torch/csrc/backward.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/backward.py:230",
             launches=t["launches"]["bwd_tables"],
             launches_by_path={"training": t["launches"]["bwd_tables"],
                               "training_k1": t["launches_k1"]["bwd_tables"],
                               "sharded_2_ranks": par["world2"]["launches"]["bwd_tables"]},
             window={"row0": 360, "local_height": 360,
                     "held_ms": par["window_ms"]["C_window"],
                     "full_held_ms": par["window_ms"]["C_full"]},
             **c),
        dict(name="env_backward",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_backward.cu",
             replaces="cpuperformanceraytracer_tpu/diff/segsum.py:46",
             launches=t["launches"]["env_backward"],
             launches_by_path={"training": t["launches"]["env_backward"],
                               "training_k1": t["launches_k1"]["env_backward"],
                               "sharded_2_ranks": par["world2"]["launches"]["env_backward"]},
             **d),
        dict(name="env_gather",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_gather.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/env_gather.py:102",
             launches=x["launches"]["env_lookup"],
             max_abs_err=max(err_e, x["err_e"]),
             **x["e"]),
        dict(name="combine",
             source="cpuperformanceraytracer_tpu_torch/csrc/combine.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/combine.py:148",
             launches=x["launches"]["combine_accumulate"], max_abs_err=err_f,
             **x["f"]),
        dict(name="tonemap",
             source="cpuperformanceraytracer_tpu_torch/csrc/tonemap.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/tonemap.py:46",
             launches=x["launches"]["tonemap"], max_abs_err=err_g,
             **x["g"]),
        *probe_rows,
    ]
    for r in rows:
        r["route"] = "cuda"
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    print(json.dumps({"kernels": rows,
                      "main_path": {"ms_per_frame": timer.mean_ms,
                                    "Mrays_per_s": mrays,
                                    "device_busy_ms_per_frame": busy_ms,
                                    "idle_share": idle, "frames": FRAMES,
                                    "warmup": WARMUP},
                      "training_path": t["summary"],
                      "textured_path": x["summary"],
                      "oracle": o, "probes": probes, "parallel": par}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
