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
   timed loop is 1 - that / ms per frame.

Then one JSON line with each kernel's numbers, the card's nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Without a GPU it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

WARMUP, FRAMES = 2, 64


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


def device_frame_ms(renderer, n: int) -> float:
    """Device milliseconds per frame with the stream kept full: a sleep
    kernel holds the stream while the host enqueues ``n`` frames, so no
    frame waits for the host (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock
    start.record()
    for _ in range(n):
        renderer.step()
    end.record()
    if start.query():
        raise AssertionError("the stream drained while frames were enqueued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


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
    planes_ref = render_planes_reference(tables, cfg, 0)
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
        OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam), FRAMES)
    idle = 1.0 - busy_ms / timer.mean_ms
    phase("main path", f"{timer.mean_ms:.4f} ms/frame; {mrays:.1f} Mrays/s "
          f"(primary, 1280x720 glass_spheres 8 bounces, env "
          f"gradient_sky(512,256)); "
          f"launches {launches}; image mean {img.mean():.2f}; accum vs "
          f"plain path {main_off:.5%} px off; device busy "
          f"{busy_ms:.4f} ms/frame, idle share {idle:.4f}; GPU {gpu}")

    print(json.dumps({"kernels": [
        {"name": "megakernel", "route": "cuda",
         "source": "cpuperformanceraytracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "cpuperformanceraytracer_tpu/kernels/megakernel.py:251",
         "launches": launches["render_planes"], "max_abs_err": glass_err,
         "ms": ms_a, "plain_ms": plain_ms_a},
        {"name": "env_accumulate", "route": "cuda",
         "source": "cpuperformanceraytracer_tpu_torch/csrc/env_accumulate.cu",
         "replaces": "cpuperformanceraytracer_tpu/kernels/megakernel.py:1162",
         "launches": launches["env_accumulate"], "max_abs_err": err_b,
         "ms": ms_b, "plain_ms": plain_ms_b},
    ], "main_path": {"ms_per_frame": timer.mean_ms, "Mrays_per_s": mrays,
                     "device_busy_ms_per_frame": busy_ms,
                     "idle_share": idle, "frames": FRAMES,
                     "warmup": WARMUP}}))
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
