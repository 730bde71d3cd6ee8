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
   flags themselves) under 0.1% of pixels off by > 1e-3;
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
   (a lottery flip on a few pixels moves a sum over all pixels);
7. kernel D (env cotangents + texel scatter) vs its plain version at
   1280x720 pixels and 512x256 texels, on kernel B's indices of phase 4:
   cot_mt exactly equal, each texel's sum within 4 * 2^-23 * sum|v| of a
   float64 index_add_;
8. the training path: fwd_bwd_benchmark(backend="cuda") at the bench
   workload (counter RNG, params albedo + 0.05, sphere centers + 0.1 and
   every env texel), 2 warmup + 64 timed steps in 2 spans; kernels C and
   D launch once per step, A and B once more for the target; gradients
   finite and within 2e-2 relative L2 of the plain path's on the card;
   the device time per step with the stream kept full and the idle
   share; then 8 Adam steps of adam_inverse_render on the albedo, whose
   loss must fall.

Then one JSON line with each kernel's numbers (times, launches on the
main paths, and the bound: the larger of its bytes over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s, counted from this run's inputs),
the card's nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Without a GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

WARMUP, FRAMES = 2, 64
STEPS = 64                      # timed training steps (2 spans)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32 FLOP/s
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12

# FP32 operations the kernels execute unconditionally, counted from
# csrc/bounce.cuh and csrc/backward.cu (add, sub, mul, div, sqrt, min,
# max, transcendental: 1 each; integer RNG work, comparisons and
# selects not counted, so the bound stays a lower bound)
FLOPS_QUAD, FLOPS_SPHERE = 44, 19      # one ray-object test
FLOPS_SHADE = 200                      # the rest of a segment
FLOPS_CAMERA = 29                      # camera ray + output sum, per pixel
FLOPS_ADJOINT = 110                    # a segment's hand-written adjoint
FLOPS_CAMERA_ADJ = 27


def bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by): the least time the card needs for the work."""
    t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


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
    blocks until the sleep ends."""
    total = 0.0
    for _ in range(windows):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(n):
            step()
        end.record()
        if start.query():
            raise AssertionError("the stream drained while work was enqueued")
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / (n * windows)


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


def phase_kernel_c(dev, glass_tables, glass_cfg) -> dict:
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
    live = []
    render_planes_reference(glass_tables, cfg, 1, 0, live_segments=live)
    ms = cuda_ms(lambda: bwd_tables(glass_tables, cfg, 1, 0, cot6), 10)
    plain_ms = cuda_ms(
        lambda: bwd_tables_reference(glass_tables, cfg, 1, 0, cot6), 2, 1)
    n_px = cfg.width * cfg.height
    n_blocks = ((cfg.width + 31) // 32) * ((cfg.height + 3) // 4)
    n_cells = sum(t.numel() for t in glass_tables)
    flops = (sum(live) * (2 * segment_flops(glass_tables) + FLOPS_ADJOINT)
             + n_px * (FLOPS_CAMERA + FLOPS_CAMERA_ADJ))
    bnd = bound(6 * 4 * n_px + 4 * n_blocks * n_cells, flops)
    phase("kernel C", f"Beer + cornell 256x64 allclose (max abs err "
          f"{strict_err:.3g}); glass 1280x720 8 bounces relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f"; {ms:.4f} ms vs plain {plain_ms:.2f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]}, {sum(live)} live segments)")
    return dict(max_abs_err=strict_err, ms=ms, plain_ms=plain_ms, bound=bnd,
                library_ms=None, rel_l2_1280x720=rels, live_segments=sum(live))


def phase_kernel_d(dev, planes, idx, tex) -> dict:
    """Phase 7: kernel D vs its plain version and a float64 texel sum."""
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import (
        env_backward,
        env_backward_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((3,) + tuple(idx.shape), device=dev, generator=gen)
    mt = planes[6:9]
    cot, d_tex = env_backward(g, idx, mt, tex)
    cot_want, _ = env_backward_reference(g, idx, mt, tex)
    torch.cuda.synchronize()
    if not torch.equal(cot, cot_want):
        raise AssertionError("kernel D: cot_mt differs from the plain version")
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
    ms = cuda_ms(lambda: env_backward(g, idx, mt, tex), 200)
    plain_ms = cuda_ms(lambda: env_backward_reference(g, idx, mt, tex), 20)
    scatter = torch.zeros((n_tex, 3), device=dev)
    library_ms = cuda_ms(lambda: scatter.index_add_(0, flat, vals), 200)
    n_px = idx.numel()
    bnd = bound(n_px * (12 + 8 + 12 + 12) + 2 * 3 * 4 * n_tex, 9 * n_px)
    phase("kernel D", f"cot_mt equal; texel sums within {worst:.3g} of the "
          f"(k-1)*2^-24*sum|v| bound (max abs err {max_err:.3g}; up to "
          f"{int(count.max())} pixels on one texel; texel sums over "
          f"4*2^-23*sum|v|: {over_fixed} here, {lib_over} with index_add_); "
          f"{ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms vs index_add_ {library_ms:.4f} ms; "
          f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound=bnd,
                library_ms=library_ms)


def phase_training(dev, scene, cam, tex, glass_cfg, gpu) -> dict:
    """Phase 8: the training path through the kernels."""
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
        default_bench_params,
        fwd_bwd_benchmark,
    )
    from cpuperformanceraytracer_tpu_torch.diff.grad import (
        loss_and_grad,
        render_for_params,
    )
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        adam_inverse_render,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import render_planes

    cfg = glass_cfg.replace(rng="counter", backend="cuda")
    kernels = (render_planes, env_accumulate, bwd_tables, env_backward)
    for k in kernels:
        k.launches = 0
    r = fwd_bwd_benchmark(cfg, scene, cam, tex, steps=STEPS, warmup_steps=2,
                          spans=2)
    launches = {k.__name__: k.launches for k in kernels}
    run = 2 + r["steps_timed"]
    expect = {"render_planes": run + 1, "env_accumulate": run + 1,
              "bwd_tables": run, "env_backward": run}
    if launches != expect:
        raise AssertionError(f"training launches {launches}, expected {expect}")
    if not r["grads_finite"]:
        raise AssertionError("training: gradients not finite")
    phase("training bench", f"{r['ms_per_step']:.4f} ms/step; "
          f"{r['Mrays_per_s']:.1f} Mrays/s; spans {r['span_ms']} ms; "
          f"launches {launches}")

    params = default_bench_params(scene, tex)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    # windows of 2 steps (~420 launches): the sleep covers four times the
    # host clock's time for them (~2 GHz)
    n = 2
    busy_ms = device_frame_ms(
        lambda: loss_and_grad(params, target, scene, cam, tex, cfg, 1), n,
        int(4 * n * r["ms_per_step"] * 1e-3 * 2.0e9), windows=8)
    idle = 1.0 - busy_ms / r["ms_per_step"]
    # the host's own time to enqueue a step (no synchronisation inside)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()

    _, got = loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    _, want = loss_and_grad(params, target, scene, cam, tex,
                            cfg.replace(backend="torch"), 1)
    rels = {k: rel_l2(got[k], want[k]) for k in params}
    if max(rels.values()) >= 2e-2:
        raise AssertionError(f"training gradients vs plain path: {rels}")

    m = scene.materials.albedo
    albedo = torch.stack([m.x, m.y, m.z], -1)
    _, losses = adam_inverse_render(
        InverseProblem(scene, cam, tex, cfg, target), {"albedo": albedo + 0.05},
        steps=8, learning_rate=0.01)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"inverse: losses {losses}")
    phase("training path", f"{r['ms_per_step']:.4f} ms/step; "
          f"{r['Mrays_per_s']:.1f} Mrays/s (1280x720 glass_spheres 8 bounces, "
          f"counter RNG, env gradient_sky(512,256)); spans {r['span_ms']} ms, "
          f"spread {r['spread']:.4f}; grads_finite {r['grads_finite']}; "
          f"launches {launches}; device busy {busy_ms:.4f} ms/step, idle "
          f"share {idle:.4f}; host enqueue {enqueue_ms:.4f} ms/step; grads "
          f"vs plain path relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f"; inverse losses {[round(x, 6) for x in losses]}; GPU {gpu}")
    summary = dict(r, device_busy_ms_per_step=busy_ms, idle_share=idle,
                   host_enqueue_ms_per_step=enqueue_ms,
                   grad_rel_l2_vs_plain=rels, inverse_losses=losses,
                   warmup_steps=2)
    return {"launches": launches, "summary": summary}


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

    b = _build.build()
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"{b.path.name} in {b.seconds:.1f} s; " + " | ".join(ptxas))
    _build.load_library()

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
    live_a = []
    planes_ref = render_planes_reference(tables, cfg, 0, live_segments=live_a)
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
    phase("kernel A", f"cornell strict ok (max abs err {max_err_a:.3g}); "
          f"glass 1280x720 robust ok on 12 planes (worst {worst} "
          f"{off[worst]:.5%} px off; missed flags differ on "
          f"{off['missed']:.5%}; rgb max abs err {glass_err:.3g}); "
          f"{ms_a:.3f} ms vs plain {plain_ms_a:.3f} ms")

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
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam)
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
                            scene=scene, camera=cam, device=dev)
    for _ in range(FRAMES):
        plain.step()
    main_off = max(robust(accum[c], plain.accum[c], f"main path channel {c}",
                          1e-2) for c in range(3))
    rays = cfg.width * cfg.height * cfg.spp
    mrays = timer.rays_per_second(rays) / 1e6
    busy_ms = device_frame_ms(
        OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam).step, FRAMES)
    idle = 1.0 - busy_ms / timer.mean_ms
    phase("main path", f"{timer.mean_ms:.4f} ms/frame; {mrays:.1f} Mrays/s "
          f"(primary, 1280x720 glass_spheres 8 bounces, env "
          f"gradient_sky(512,256)); "
          f"launches {launches}; image mean {img.mean():.2f}; accum vs "
          f"plain path {main_off:.5%} px off; device busy "
          f"{busy_ms:.4f} ms/frame, idle share {idle:.4f}; GPU {gpu}")

    # ---- phases 6-8 --------------------------------------------------------
    c = phase_kernel_c(dev, tables, cfg)
    d = phase_kernel_d(dev, planes, gi, tex)
    t = phase_training(dev, scene, cam, tex, cfg, gpu)

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
                               "training": t["launches"]["render_planes"]},
             live_segments=sum(live_a)),
        dict(name="env_accumulate",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_accumulate.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/megakernel.py:1162",
             launches=launches["env_accumulate"], max_abs_err=err_b,
             ms=ms_b, plain_ms=plain_ms_b, bound=bound_b, library_ms=None,
             launches_by_path={"forward": launches["env_accumulate"],
                               "training": t["launches"]["env_accumulate"]}),
        dict(name="bwd_tables",
             source="cpuperformanceraytracer_tpu_torch/csrc/backward.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/backward.py:230",
             launches=t["launches"]["bwd_tables"], **c),
        dict(name="env_backward",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_backward.cu",
             replaces="cpuperformanceraytracer_tpu/diff/segsum.py:46",
             launches=t["launches"]["env_backward"], **d),
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
                      "training_path": t["summary"]}))
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
