"""The card's correctness gate for the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

It checks that every kernel builds and agrees with its plain version on
the card, that the main paths launch what they should, and that the
drivers run; it times only the probe kernels (phase 14), which no cell
of the benchmark measures. The main path's speed is the benchmark's:
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds 10
--trace <0|1>``, on each tree to compare.

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
   utilisation at 720p as the persistent kernel counts it (``lane_stats``),
   its ptxas registers and spills, and its resident blocks;
4. kernel B (env resolve + accumulate) vs its plain version on the same
   planes: texel indices equal on >= 99.9% of pixels, the accumulator
   allclose (rtol 1e-5) where they are equal; then the chain kernel A ->
   kernel B vs plain A -> plain B, under 0.1% of pixels off by > 1e-3;
5. main path: OfflineRenderer(backend="cuda") at the bench workload
   (1280x720, glass_spheres, 8 bounces, 1 spp, equirect stochastic env,
   wang RNG), 2 warmup + 64 frames; both launch counters must equal 66;
   the image is finite with a nonzero mean, and the accumulator agrees
   with the plain-torch path's on the card pixel by pixel (means within
   1e-2 relative, under 1% of pixels off by > 1e-3: 64 frames, each of
   which may flip a path);
6. kernel C (the adjoint megakernel) vs its plain version (autograd of
   the plain kernel A) on seeded cotangents: the Beer scene (one glass
   sphere every path refracts through, a geometry gradient) and
   cornell_box without env, 256x64, 2 bounces, every table cotangent
   allclose (rtol 1e-3, atol 1e-3 of the largest reference cotangent:
   the kernel sums in another order); glass_spheres + gradient_sky(512,
   256) at 1280x720, 8 bounces, relative L2 error under 2e-2 per table
   (a lottery flip on a few pixels moves a sum over all pixels); two
   launches bit-equal (fixed-order sums); its lane utilisation as the
   kernel counts it, its ptxas registers and spills;
7. kernel D (env cotangents + texel scatter) vs its plain version at
   1280x720 pixels and 512x256 texels, on kernel B's indices of phase 4:
   cot_mt exactly equal, each texel's sum of k values within
   (k - 1) * 2^-24 * sum|v| (at least 8 * 2^-24 * sum|v|) of a float64
   index_add_; two calls bit-equal (fixed-order sums); the busiest texel
   with and without the zero addends (which the kernel drops);
8. the training path: fwd_bwd_benchmark(backend="cuda") at the bench
   workload (counter RNG, params albedo + 0.05, sphere centers + 0.1 and
   every env texel), JAX's protocol (6 warmup calls, one untimed span,
   64 steps in 2 spans), once at K = 16 steps a dispatch (one CUDA graph
   of 16 steps) and once at K = 1 (the per-step loop), gradients finite.
   Each run is traced by torch.profiler, which counts the launches of
   kernels A, B, C and D on the device: one a step of every warmup,
   untimed and timed call, 16 more at K = 16 for the capture's warm-up
   run, and A and B once more for the target; the wrappers' counters,
   which count no capture and cannot see a replay, count the launches
   outside the graph (a trace the profiler left short, every count at
   most the expected one, is taken again, up to 3 times, and the last
   must match exactly). torch.profiler over one replay of a K = 16 graph
   counts 16 launches each of A-D (a short trace taken again as above);
   the graphed grad_sum and losses bit-equal to 16 ungraphed steps
   summed in order, and 16 graphed Adam steps (capturable) leave the
   parameters and losses bit-equal to 16 ungraphed ones, Adam's kernel
   counted from 0 just before each side (16 launches in the capture's
   warm-up run, 16 in the graph's replay, 16 in the ungraphed loop);
   gradients finite and within 2e-2 relative L2 of the plain path's on
   the card; two steps on one frame bit-equal (loss and gradients); the
   same step with a cubemap env (six gradient_sky(256, 256) faces)
   within 2e-2 relative L2 of the plain path's; then 8 Adam steps of
   adam_inverse_render on the albedo (one graph of 8), whose loss must
   fall, with 8 launches of Adam's kernel in the capture's warm-up run.
   Adam's kernel (kernels/adam.py) at the training leaves of the 720p
   and 1080p cells (albedo 11x3, sphere centers 7x3, 131072 or 2097152
   texels x 3): 16 steps bit-equal to torch.optim.Adam(capturable=True)
   in params and state, 16 launches counted from 0 just before them;
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
   stochastic) with a gradient_sky(2048, 1024) env, 2 warmup + 16
   frames; kernels A and E launch 16 times a frame, F once; kernel E vs
   its plain version on one frame's 16 samples at these shapes (1080p
   planes, the 2k env), by phase 9's rules; after 2 frames the
   accumulator agrees with the plain path's on the card (means within
   1e-2, under 1% of pixels off by > 1e-3); one 720p frame each of
   bilinear equirect and cubemap nearest through the same route, checked
   the same way; a PNG written through kernel G (one launch);
13. checkpoint/resume on the card: 8 textured_1080 frames saved every 4,
   a new renderer resumed for 4 more, bit-equal to 12 frames in one run;
14. the probes (kernels K6-K8, built into their own library in phase 2):
   with the probe kernels' launch counts set to 0, the three probe entry
   points run as a user runs them (``probes.trace_probe``, ``probes.
   gather_bench``, ``probes.overlap_probe``: P1 kernel A and the texel
   gather on two streams, P2 row copies with 1 to 8 in flight, P3 the
   cluster gather) and every probe kernel must have launched; then each
   kernel against its plain version on the card: K6 on the CUDA cores at
   rtol 1e-6 (the same chains in the same order), on the tensor cores
   (3xTF32) per warp (mma.sync) and per warpgroup (wgmma), each under
   1e-4 max relative error against the CUDA cores, wgmma also against
   the plain version, two wgmma launches bit-equal; the CUDA cores' issue
   bound under --fmad=false at the SM clock read (nvidia-smi clocks.sm)
   while they run; K7 in all three layouts at 0, 1, 3, 5, 2048 and
   921600 queries and on index views 4, 8 and 12 bytes off, K8a (TMA and
   cp.async, 512- and 16-byte rows, 256 to 4096 copies, 1, 2, 4 and 8 in
   flight) and K8b (0, 1, 3, 5, 2048 and 921600 queries and views one
   int32 off; two launches bit-equal) bit-equal; K8a's in-flight bound n
   t1 / depth from its depth-1 time in the same run; the ptxas registers
   and spills of K6 and K7;
15. the oracle integrator (backend "oracle", plain torch on the card):
   OfflineRenderer at the forward workload, 1 warmup + 4 frames, against
   the kernel route's 4 frames (means within 1e-2, under 1% of pixels
   off by > 1e-3: the oracle takes the sphere normal as
   safe_normalize(hit_rel), kernel A as hit_rel * (1/r)), with its peak
   memory; the cornell box 256x64, 2 bounces, against kernel A at rtol
   1e-4, atol 1e-5; path-replay gradients (diff/path_replay.py) against
   plain autograd through the oracle at 320x180, 8 bounces, bilinear env
   (which the kernel routes refuse), rtol 1e-4 and atol 1e-7, with the
   peak memory of each;
16. the parallel layer, the row windows, the native codec and the
   profiler. Right after phase 5: ``make -C native`` and the native RGBE
   decode and BMP encode equal to the numpy path; one forward frame under
   ``utils/profiling.trace``, whose Chrome trace must name kernel A. Last:
   kernels A and C on the lower 360 rows of the 720p frame (A bit-equal to
   those rows of a whole launch, C bit-equal on two launches); a world of
   1 (no process group) bit-equal to the unsharded kernel route; a gloo
   world of 2 ranks on the one card (``parallel.mesh.spawn_world``): px =
   2 forward frames (wang and counter) bit-equal to the unsharded kernel
   route, px = 1 x spp = 2 at spp 2 within 1e-5 absolute, a sharded
   training step (px = 2, counter) with its loss within 1e-5 relative and
   its gradients under 1e-5 relative L2 of the unsharded K = 1 step, two
   sharded steps bit-equal, the f32 elements its collectives move equal
   to ``parallel/budget``'s model, kernels A-D launched by the ranks (the
   counts set to 0 just before); then ``parallel.scaling.measure_scaling``
   runs over worlds of 1 and 2 ranks at the forward workload;
17. the drivers of BASELINE configs 5 and 4 and of the headline metric,
   run as a user runs them, each with the launch counts of kernels A, B,
   C, D, G, Adam's and the deflate's set to 0 just before it and read
   just after (C and D must launch where the driver takes gradients,
   Adam's kernel where it trains, the deflate where it saves; a CUDA
   graph's replays are not
   counted, its capture's warm-up run is): ``scripts.run_offline_4k.
   run_offline`` at 3840x2160 x 1024 frames (phase 1 to frame 512 with a
   checkpoint every 128, a fresh renderer resumed for the rest, each save
   deflated on the card), its
   accumulator bit-equal to one uninterrupted 1024-frame run without
   checkpoints, finite, with a nonzero mean; kernel G on its accumulator
   by phase 11's rules; the deflate (``kernels/deflate.py``) on its three
   planes laid end to end as a save lays them, each CRC-32 started from
   the ``.npy`` header's: on the first 2 MiB of each plane the streams
   and CRC-32s equal to ``deflate_reference``'s byte for byte, and the
   whole planes' streams inflating to the planes; one 4K frame of
   kernels A and B against their
   plain versions by phases 3 and 4's; ``scripts.inverse_env_demo.
   inverse_env`` at its own size (256x144, spp 2, 3 bounces, every one of
   the 131072 texels trained, 200 steps at K = 16), whose loss must fall
   and whose parameters must be finite, with each material's albedo
   error; its first step's gradients (A-D at spp 2, T > P) within 2e-2
   relative L2 of the plain path's on the card, and the same 200 steps on
   the plain path on the card (``backend="torch"``: torch's own
   capturable Adam, no launch of Adam's kernel), whose losses the
   kernels' must match within 1e-4 relative at every step and whose
   albedos within 1e-4; ``bench.headline``, whose gradients must be
   finite; and the training step at 720p, K = 16, with a
   ``gradient_sky(2048, 1024)`` env (2097152 texels against 921600
   pixels: config 3's T ~ P regime), gradients finite, and kernel D at
   its shapes (the 720p planes' indices into the 2048x1024 env) by phase
   7's rules.

Then one JSON line with each kernel's numbers (its error against the
plain version, the deflate's in bytes that differ, launches on the main
paths, the deflate's bound over a 4K save's bytes; for a probe kernel its times
and the bound: the larger of its bytes over 3.35 TB/s and its operations
over the peak of their type (FP32 67 TFLOP/s, TF32 on the tensor cores
495 TFLOP/s), counted from this run's inputs, and launches, those of the
probe entry points, on no render path), the card's nvidia-smi line, and
last ``{"ok": true, "device": {...}}``. Without a GPU it exits non-zero
before printing any result.
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
STEPS = 64                      # the training bench's steps (2 spans)
STEPS_PER_DISPATCH = 16         # the training bench's K (JAX's default)
WARMUP_CALLS = 6                # fwd_bwd_benchmark's warmup calls

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32 FLOP/s,
# TF32 tensor-core FLOP/s
PEAK_BYTES, PEAK_FLOPS, PEAK_TF32 = 3.35e12, 67e12, 495e12


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the least time the card needs for the work."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_FLOPS, tf32_flops / PEAK_TF32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).norm()
            / want.double().norm()).item()


def hold_planes(planes, ref, what: str) -> tuple:
    """Kernel A's planes against the plain version's (phase 3's glass
    rule): the rgb and miss-throughput means within 1e-2 relative and
    under 0.1% of pixels off by > 1e-3, and under 0.1% of pixels off on
    each of the 12 planes; returns (share off by plane, the worst)."""
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        PLANE_NAMES,
        plane_mismatch,
    )

    for c in (0, 1, 2, 6, 7, 8):
        robust(planes[c], ref[c], f"{what} {PLANE_NAMES[c]}", 1e-3)
    off = plane_mismatch(planes, ref)
    worst = max(off, key=off.get)
    if off[worst] >= 1e-3:
        raise AssertionError(f"{what} planes: {off}")
    return off, worst


def hold_env_accumulate(planes, planes_ref, tex, cfg, accum0, blend,
                        what: str) -> tuple:
    """Kernel B against its plain version on kernel A's planes (phase 4's
    rule): texel indices equal on >= 99.9% of pixels, the accumulator
    allclose (rtol 1e-5) where they are; then A -> B against plain A ->
    plain B, under 0.1% of pixels off by > 1e-3. Returns (share of
    indices equal, max abs err, share of pixels off in the chain, the
    kernel's indices)."""
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
        env_accumulate,
        env_accumulate_reference,
    )

    got, want = accum0.clone(), accum0.clone()
    gi = torch.empty(planes.shape[1:], dtype=torch.int64, device=planes.device)
    wi = torch.empty_like(gi)
    env_accumulate(planes, tex, cfg, got, blend, index_out=gi)
    env_accumulate_reference(planes, tex, cfg, want, blend, index_out=wi)
    torch.cuda.synchronize()
    same = gi == wi
    same_share = same.double().mean().item()
    if same_share < 0.999:
        raise AssertionError(f"{what}: indices equal on {same_share:.4%}")
    torch.testing.assert_close(got[:, same], want[:, same], rtol=1e-5, atol=0)
    err = (got[:, same] - want[:, same]).abs().max().item()
    # the chain: kernel A's planes through kernel B vs the plain chain
    chain_ref = accum0.clone()
    env_accumulate_reference(planes_ref, tex, cfg, chain_ref, blend)
    chain_off = max(robust(got[c], chain_ref[c], f"{what} chain A->B "
                           f"channel {c}", 1e-3) for c in range(3))
    return same_share, err, chain_off, gi


def hold_env_backward(g, idx, mt, tex, what: str) -> dict:
    """Kernel D against its plain version and a float64 texel sum (phase
    7's rule): cot_mt exactly equal, two calls bit-equal, each texel's sum
    of k values within (k - 1) * 2^-24 * sum|v| (at least 8 * 2^-24 *
    sum|v|) of a float64 index_add_. Returns the max abs error, the worst
    error over its bound, the texel sums over 4 * 2^-23 * sum|v|, and the
    flat indices, values and counts."""
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import (
        env_backward,
        env_backward_reference,
    )

    dev = g.device
    cot, d_tex = env_backward(g, idx, mt, tex)
    cot_want, _ = env_backward_reference(g, idx, mt, tex)
    _, again = env_backward(g, idx, mt, tex)
    torch.cuda.synchronize()
    if not torch.equal(cot, cot_want):
        raise AssertionError(f"{what}: cot_mt differs from the plain version")
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(d_tex, again)):
        raise AssertionError(f"{what}: two calls differ")
    n_tex = tex.width * tex.height
    flat = idx.reshape(-1)
    vals = (g * mt).reshape(3, -1).t().contiguous()
    count = torch.bincount(flat, minlength=n_tex).double()
    # a sum of k f32 terms in any order is within (k - 1) * 2^-24 * sum|v|
    # of the exact sum (at least the fixed 4 * 2^-23 * sum|v| is allowed),
    # plus 2^-126 per add: f32 atomics flush subnormals to zero
    allow = torch.clamp(count - 1.0, min=8.0) * 2.0 ** -24
    ftz = 2.0 * count * 2.0 ** -126
    max_err, worst, over_fixed = 0.0, 0.0, 0
    for c in range(3):
        v = vals[:, c].double()
        exact = torch.zeros(n_tex, dtype=torch.float64, device=dev)
        exact.index_add_(0, flat, v)
        mag = torch.zeros_like(exact).index_add_(0, flat, v.abs())
        err = (d_tex[c].double() - exact).abs()
        if (err > allow * mag + ftz).any():
            raise AssertionError(f"{what} channel {c}: a texel sum is off "
                                 f"by more than (k - 1) * 2^-24 * sum|v|")
        max_err = max(max_err, err.max().item())
        hit = mag > 0
        worst = max(worst, (err[hit] / (allow * mag + ftz)[hit]).max().item())
        over_fixed += int((err > 4 * 2.0 ** -23 * mag).sum())
    return dict(max_err=max_err, worst=worst, over_fixed=over_fixed,
                flat=flat, vals=vals, count=count)


def hold_tonemap(acc, what: str) -> tuple:
    """Kernel G against its plain version on ``acc`` (phase 11's rule): f32
    within rtol 1e-5, u8 equal on >= 99.99% of values and never off by
    more than 1. Returns (max abs err, share of u8 equal, max u8 off)."""
    from cpuperformanceraytracer_tpu_torch.core.color import to_u8
    from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
    from cpuperformanceraytracer_tpu_torch.kernels.tonemap import (
        tonemap,
        tonemap_reference,
    )

    got, want = tonemap(acc, 1.0), tonemap_reference(acc, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0,
                               msg=lambda m: f"kernel G {what}: {m}")
    d = (to_u8(Vec3(*got)).int() - to_u8(Vec3(*want)).int()).abs()
    eq = (d == 0).double().mean().item()
    if eq < 0.9999 or d.max().item() > 1:
        raise AssertionError(f"kernel G {what}: u8 equal on {eq:.5%}, "
                             f"max off {d.max().item()}")
    return (got - want).abs().max().item(), eq, d.max().item()


DEFLATE_CUT = 2 << 20           # bytes of each 4K plane held to the plain deflate


def hold_deflate(accum: torch.Tensor, what: str) -> dict:
    """The deflate kernel on ``accum``'s planes, laid end to end as a save
    lays them, each CRC-32 started from its ``.npy`` header's: the first
    ``DEFLATE_CUT`` bytes of each plane (the main path's slices, the
    windows before them included) byte for byte and CRC for CRC equal to
    the plain version's, and the whole planes' streams inflating to the
    planes. Returns the bytes that differ, the launches, and the whole
    save's bytes and bound."""
    import io
    import zlib

    import numpy as np
    from numpy.lib import format as npy

    from cpuperformanceraytracer_tpu_torch.kernels.deflate import (
        deflate,
        deflate_reference,
    )

    planes = accum.detach().contiguous()
    head = io.BytesIO()
    npy.write_array_header_1_0(head, {"descr": "<f4", "fortran_order": False,
                                      "shape": tuple(planes.shape[1:])})
    starts = [zlib.crc32(head.getvalue())] * 3
    raw = planes.view(3, -1).view(torch.uint8)
    cut = raw[:, :DEFLATE_CUT].contiguous().view(-1)
    made = deflate.launches
    got = deflate(cut, [DEFLATE_CUT] * 3, starts).fetch()
    want = deflate_reference(cut.cpu().numpy(), [DEFLATE_CUT] * 3, starts)
    off = 0
    for (g, gc), (w, wc) in zip(got, want):
        g, w = np.frombuffer(bytes(g), np.uint8), np.frombuffer(w, np.uint8)
        n = min(len(g), len(w))
        off += abs(len(g) - len(w)) + int((g[:n] != w[:n]).sum()) + int(
            gc != wc)
    if off:
        raise AssertionError(f"deflate {what}: the kernel's streams or CRCs "
                             f"differ from the plain version's in {off} "
                             f"bytes")
    whole = deflate(raw.view(-1), [raw.shape[1]] * 3, starts).fetch()
    host = raw.cpu().numpy()
    for c, (stream, crc) in enumerate(whole):
        body = zlib.decompressobj(-15).decompress(bytes(stream))
        if body != host[c].tobytes() or crc != zlib.crc32(body, starts[c]):
            raise AssertionError(f"deflate {what}: plane {c} does not "
                                 f"inflate to its bytes")
    written = sum(len(s) for s, _ in whole)
    return dict(bytes_off=off, launches=deflate.launches - made,
                cut_bytes=cut.numel(), plane_bytes=raw.numel(),
                written_bytes=written,
                bound=bound(raw.numel() + written, 0.0))


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


def phase_kernel_c(dev, glass_tables, glass_cfg, build_log) -> dict:
    """Phase 6: kernel C vs its plain version; its numbers for the JSON."""
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.kernels.backward import (
        bwd_tables,
        bwd_tables_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import pack_tables
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
    # fixed-order sums: a second launch gives the same bits
    again = bwd_tables(glass_tables, cfg, 1, 0, cot6)
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again)):
        raise AssertionError("kernel C: two launches differ")
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    bwd_tables(glass_tables, cfg, 1, 0, cot6, lane_stats=stats)
    util = stats[0].item() / stats[1].item()
    regs = ptxas_of(build_log, "bwd_tables_kernel")
    phase("kernel C", f"Beer + cornell 256x64 allclose (max abs err "
          f"{strict_err:.3g}); glass 1280x720 8 bounces relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f"; two launches bit-equal; lane utilisation {util:.4f}; "
          f"ptxas: {regs}")
    return dict(max_abs_err=strict_err, rel_l2_1280x720=rels,
                bit_equal_twice=True, lane_utilisation=util, ptxas=regs)


def phase_kernel_d(dev, planes, idx, tex) -> dict:
    """Phase 7: kernel D vs its plain version and a float64 texel sum."""
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((3,) + tuple(idx.shape), device=dev, generator=gen)
    held = hold_env_backward(g, idx, planes[6:9], tex, "kernel D")
    max_err, worst, count = held["max_err"], held["worst"], held["count"]
    flat, vals = held["flat"], held["vals"]
    nonzero = (vals != 0).any(1)
    busiest_nz = int(torch.bincount(flat[nonzero],
                                    minlength=tex.width * tex.height).max())
    phase("kernel D", f"cot_mt equal; two calls bit-equal; texel sums within "
          f"{worst:.3g} of the "
          f"(k-1)*2^-24*sum|v| bound (max abs err {max_err:.3g}; busiest "
          f"texel {int(count.max())} pixels, {busiest_nz} with a nonzero "
          f"addend ({int(nonzero.sum())} of {idx.numel()} pixels); texel "
          f"sums over 4*2^-23*sum|v|: {held['over_fixed']})")
    return dict(max_abs_err=max_err, bit_equal_twice=True,
                busiest_texel={"all": int(count.max()), "nonzero": busiest_nz})


def replay_profile(step) -> dict:
    """The launches of kernels A-D, by name, in one call of ``step`` on
    the device (torch.profiler's CUDA activity; a CUDA graph replay shows
    each of its kernel nodes)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return {name: sum(e.count for e in prof.key_averages() if name in e.key)
            for name in TRAIN_KERNELS.values()}


# traces of the training run a short trace may take (see phase_training)
TRACE_ATTEMPTS = 3

# kernels A-D by their CUDA function names (D's first kernel: the runs)
TRAIN_KERNELS = {"render_planes": "render_planes_kernel",
                 "env_accumulate": "env_accumulate_kernel",
                 "bwd_tables": "bwd_tables_kernel",
                 "env_backward": "env_runs_kernel"}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def phase_training(dev, scene, cam, tex, glass_cfg) -> dict:
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
    )
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        adam_inverse_render,
        make_train_step,
        make_train_step_k,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.adam import adam
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import render_planes
    from cpuperformanceraytracer_tpu_torch.utils import profiling

    cfg = glass_cfg.replace(rng="counter", backend="cuda")
    kernels = (render_planes, env_accumulate, bwd_tables, env_backward)
    params = default_bench_params(scene, tex)
    loss_fn = bench_loss(cfg, scene, cam, tex)
    runs = {}
    for k in (STEPS_PER_DISPATCH, 1):
        # the main path's run, traced: kernel launches on the device.
        # torch.profiler's CUDA activity now and then lacks records of
        # graph replays (a trace short by part of a replay, the wrapper
        # counts exact): such a short trace is taken again, at most
        # TRACE_ATTEMPTS times, and the last one must match exactly
        for attempt in range(1, TRACE_ATTEMPTS + 1):
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
            del prof
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
            if not (wrapper == expect_wrapper and launches != expect
                    and all(launches[n] <= expect[n] for n in expect)):
                break
            print(f"[training bench] K={k}: trace {attempt} short, device "
                  f"launches {launches}, expected {expect}; traced again",
                  flush=True)
        if launches != expect or wrapper != expect_wrapper:
            raise AssertionError(
                f"training K={k}: device launches {launches}, expected "
                f"{expect}; wrapper counts {wrapper}, expected "
                f"{expect_wrapper} (trace {attempt} of {TRACE_ATTEMPTS})")
        if not traced["grads_finite"] or traced["steps_per_dispatch"] != k:
            raise AssertionError(f"training K={k}: {traced}")
        runs[k] = dict(launches=launches, wrapper_launches=wrapper,
                       trace_attempts=attempt, loss=traced["loss"])
        phase("training bench", f"K={k}: gradients finite; device launches "
              f"{launches} ({steps_run} steps; trace {attempt}), wrapper "
              f"counts {wrapper}")

    # one replay of the K-step graph: K launches of each of kernels A-D
    step_k = make_grad_step_k(loss_fn, STEPS_PER_DISPATCH)
    got_sum, got_losses = step_k(params, 1)
    want = {name: STEPS_PER_DISPATCH for name in TRAIN_KERNELS.values()}
    for attempt in range(1, TRACE_ATTEMPTS + 1):        # as the traced runs
        replay = replay_profile(lambda: step_k(params, 1))
        if replay == want or any(replay[n] > want[n] for n in want):
            break
        print(f"[training bench] one replay: trace {attempt} short, "
              f"{replay}; traced again", flush=True)
    if replay != want:
        raise AssertionError(f"one replay launched {replay}, expected {want} "
                             f"(trace {attempt} of {TRACE_ATTEMPTS})")
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
    # Adam's kernel on each side, its count set to 0 just before it: the
    # capture's warm-up run and the graph's replay, then the per-step loop
    adam.launches = 0
    replayed = profiling.replayed_launches().get("adam", 0)
    graphed = make_train_step_k(problem, opt_g, STEPS_PER_DISPATCH,
                                resample_frames=True)
    lg = graphed(pg, 1)
    adam_launches = {
        "training_capture_warm_up": adam.launches,
        "training": profiling.replayed_launches().get("adam", 0) - replayed}
    adam.launches = 0
    plain = make_train_step(problem, opt_u, resample_frames=True)
    lu = torch.stack([plain(pu, 1 + i) for i in range(STEPS_PER_DISPATCH)])
    adam_launches["training_k1"] = adam.launches
    torch.cuda.synchronize()
    if adam_launches != dict.fromkeys(adam_launches, STEPS_PER_DISPATCH):
        raise AssertionError(f"Adam's kernel launched {adam_launches}, "
                             f"expected {STEPS_PER_DISPATCH} on each path")
    if not (bits_equal(lg, lu) and all(bits_equal(pg[n].detach(),
                                                   pu[n].detach())
                                       for n in params)):
        raise AssertionError("graphed Adam steps differ from ungraphed ones")
    del pg, pu, opt_g, opt_u, graphed

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
    adam.launches = 0
    _, losses = adam_inverse_render(problem, {"albedo": albedo + 0.05},
                                    steps=8, learning_rate=0.01)
    adam_launches["inverse_8_steps_capture_warm_up"] = adam.launches
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"inverse: losses {losses}")
    if adam.launches != 8:
        raise AssertionError(f"inverse: Adam's kernel launched "
                             f"{adam.launches} times in the capture's "
                             f"warm-up run of 8 steps")
    g, u = runs[STEPS_PER_DISPATCH], runs[1]
    phase("training path", f"1280x720 glass_spheres 8 bounces, counter RNG, "
          f"env gradient_sky(512,256): one replay of K={STEPS_PER_DISPATCH} "
          f"launched {replay}; graphed grad_sum and losses "
          f"bit-equal to {STEPS_PER_DISPATCH} ungraphed steps; "
          f"{STEPS_PER_DISPATCH} graphed Adam steps bit-equal to ungraphed "
          f"capturable ones, Adam's kernel launched {adam_launches}; two "
          f"steps bit-equal; grads vs plain path "
          f"relative L2 " + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
          + "; cubemap step vs plain path "
          + ", ".join(f"{n} {v:.3e}" for n, v in crels.items())
          + f"; inverse losses {[round(x, 6) for x in losses]}")
    summary = dict(k16=g, k1=u, replay_kernel_launches=replay,
                   graphed_bit_equal=True, adam_graphed_bit_equal=True,
                   grad_rel_l2_vs_plain=rels, bit_equal_twice=True,
                   cubemap_grad_rel_l2_vs_plain=crels, inverse_losses=losses)
    return {"launches": g["launches"], "launches_k1": u["launches"],
            "adam_launches": adam_launches, "summary": summary}


TEXTURED_FRAMES = 16            # timed textured_1080 frames (phase 12)
OUT_DIR = "build/chip_smoke"    # the PNG and the checkpoint (gitignored)


def cubemap_texture(dev, size: int):
    """Six gradient_sky(size, size) faces stacked: a cubemap fixture."""
    import numpy as np

    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    return texture_from_array(np.concatenate(
        [gradient_sky(size, size, seed=i) for i in range(6)]), dev)


def phase_kernel_adam(dev) -> dict:
    """Adam's kernel at the train cells' leaf shapes: {cell: numbers}."""
    from cpuperformanceraytracer_tpu_torch.kernels.adam import adam, adam_step

    out = {}
    for cell, texels in (("720p", 131072), ("1080p", 2097152)):
        shapes = ((11, 3), (7, 3), (texels, 3))
        gen = torch.Generator(device=dev).manual_seed(0)
        start = [0.5 + torch.rand(s, device=dev, generator=gen) for s in shapes]
        grads = [[torch.randn(s, device=dev, generator=gen) * 10.0 ** -(k % 4)
                  for s in shapes] for k in range(16)]

        def fresh():
            leaves = [t.clone().requires_grad_() for t in start]
            return leaves, torch.optim.Adam(leaves, lr=0.01, capturable=True)

        (got, opt_got), (want, opt_want) = fresh(), fresh()
        adam.launches = 0
        for gs in grads:
            for a, b, g in zip(got, want, gs):
                a.grad, b.grad = g, g.clone()
            adam_step(opt_got)
            opt_want.step()
        torch.cuda.synchronize()
        made = adam.launches
        if made != len(grads):
            raise AssertionError(f"Adam at {cell}: {made} launches for "
                                 f"{len(grads)} steps")
        for a, b in zip(got, want):
            pairs = [(a.detach(), b.detach())] + [
                (opt_got.state[a][k], opt_want.state[b][k])
                for k in ("step", "exp_avg", "exp_avg_sq")]
            if not all(bits_equal(x, y) for x, y in pairs):
                raise AssertionError(f"Adam at {cell}: the kernel's params "
                                     f"or state differ from torch's")
        n = sum(math.prod(s) for s in shapes)
        out[cell] = dict(elements=n, launches=made)
        phase("kernel adam", f"{cell}: {n} values, 16 steps bit-equal to "
              f"torch's capturable Adam; {made} launches for the 16 steps, "
              f"counted from 0")
    return out


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
    gen = torch.Generator(device=dev).manual_seed(4)
    seeded = torch.rand((3, 1080, 1920), device=dev, generator=gen) * 8.0
    seeded[:, 0, :4] = torch.tensor([0.0, 1e-12, 1e-3, 50.0], device=dev)
    err, worst_eq, worst_d = 0.0, 1.0, 0
    for name, acc in (("seeded 1080p", seeded), ("main path 720p", accum720)):
        e, eq, d = hold_tonemap(acc, name)
        err, worst_eq, worst_d = max(err, e), min(worst_eq, eq), max(worst_d, d)
    phase("kernel G", f"f32 rtol 1e-5 (max abs err {err:.3g}); u8 equal on "
          f">= {worst_eq:.5%} of values, max off {worst_d}")
    return err


def phase_textured(dev) -> dict:
    """Phase 12: the textured multi-sample path through kernels A, E, F
    and the display through G; kernel E at its shapes."""
    import os

    from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu_torch.kernels.combine import combine_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_gather import (
        env_lookup,
        env_lookup_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.tonemap import tonemap
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    cfg = BENCH_CONFIGS["textured_1080"].replace(
        warmup_frames=WARMUP, num_frames=TEXTURED_FRAMES, backend="cuda")
    tex = texture_from_array(gradient_sky(2048, 1024), dev)
    scene, cam = scene_by_name(cfg.scene, device=dev)
    kernels = (render_planes, env_lookup, combine_accumulate, env_accumulate)
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam, silent=True)
    for k in kernels:
        k.launches = 0
    r.run()
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
    del r

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

    # kernel E vs its plain version at this path's shapes (1080p planes, a
    # 2048x1024 env): every sample of one frame, phase 9's rules
    one = cfg.replace(spp=1)
    tables = pack_tables(scene, cam, cfg, dev)
    n_px = cfg.width * cfg.height
    planes = torch.empty((12, cfg.height, cfg.width), device=dev)
    e4 = torch.empty((n_px, 4), device=dev)
    taps = torch.empty((n_px, 4), dtype=torch.int64, device=dev)
    taps_w = torch.empty_like(taps)
    share_e, err_e = 1.0, 0.0
    for s_ in range(cfg.spp):
        render_planes(tables, one, 3, sample0=s_, out=planes)
        env_lookup(planes, tex, cfg, out=e4, taps_out=taps)
        want = env_lookup_reference(planes, tex, cfg, taps_out=taps_w)
        same = (taps == taps_w).all(-1)
        share = same.double().mean().item()
        if share < 0.999:
            raise AssertionError(f"kernel E textured_1080 sample {s_}: taps "
                                 f"equal on {share:.4%}")
        torch.testing.assert_close(
            e4[same], want[same], rtol=1e-6, atol=0,
            msg=lambda m: f"kernel E textured_1080 sample {s_}: {m}")
        share_e = min(share_e, share)
        err_e = max(err_e, (e4[same] - want[same]).abs().max().item())
        del want, same
    phase("textured path", f"textured_1080 (1920x1080 glass_spheres 16 spp "
          f"8 bounces, counter RNG, env gradient_sky(2048,1024)): launches "
          f"{launches}; image mean {img_mean:.2f}; vs plain path "
          + ", ".join(f"{k} {v:.5%} px off" for k, v in offs.items())
          + f"; E vs plain on 16 samples: taps equal on >= {share_e:.5%}, "
          f"rows max abs err {err_e:.3g} where equal")
    summary = dict(frames=TEXTURED_FRAMES, warmup=WARMUP,
                   px_off_vs_plain=offs, image_mean=img_mean)
    return dict(launches=launches, summary=summary, err_e=err_e)


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


def sm_clock_under_load(fn, calls: int) -> float:
    """The highest SM clock in MHz that nvidia-smi reports (clocks.sm,
    sampled every 50 ms) while ``calls`` calls of ``fn`` run back to back
    on the card: the highest clock gives the least time, so a bound taken
    at it stays a bound."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    return max(float(v) for v in out.split())


def phase_probes(dev, gpu, probe_log: str) -> tuple:
    """Phase 14: the probe entry points with counted launches, then K6-K8
    against their plain versions; the four kernels' JSON rows. Times are
    device times with the stream held full (``device_ms``), except the
    plain K6 (7290 torch ops a call: two calls back to back, timed on the
    host's clock to a synchronise)."""
    from cpuperformanceraytracer_tpu_torch.probes import (
        gather_bench,
        overlap_probe,
        trace_probe,
    )
    from cpuperformanceraytracer_tpu_torch.utils.timing import Timer, device_ms

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
    wg = trace_probe.trace_dots(x, B, "wgmma")
    wg_err = trace_probe.max_rel_err(wg, got)
    wg_err_plain = trace_probe.max_rel_err(wg, want)
    if not (wg_err < 1e-4 and wg_err_plain < 1e-4):
        raise AssertionError(f"K6 wgmma: max rel err {wg_err} vs cuda_core, "
                             f"{wg_err_plain} vs plain")
    if not bits_equal(wg, trace_probe.trace_dots(x, B, "wgmma")):
        raise AssertionError("K6 wgmma: two launches differ")
    torch.cuda.synchronize()
    with Timer() as plain_timer:
        for _ in range(2):
            trace_probe.trace_dots_reference(x, B)
        torch.cuda.synchronize()
    plain_k6 = plain_timer.ms / 2
    chain = trace_probe.REPEAT * n * 55
    flops_cc = trace_probe.REPEAT * n * trace_probe.NCOL * 15 + chain
    bound_cc = bound(n * 9 * 4, flops_cc)
    bound_tc = bound(n * 9 * 4, chain, 3 * trace_probe.REPEAT * n * 56 * 8 * 2)
    # under --fmad=false each mul and add is an instruction: the SMs issue
    # 128 lanes a clock each, at the clock read while the CUDA cores run
    mhz = sm_clock_under_load(lambda: trace_probe.trace_dots(x, B, "cuda_core"), 5000)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    issue_cc = flops_cc / (sms * 128 * mhz * 1e6) * 1e3
    ptxas_k6 = {unit: ptxas_of(probe_log, f"trace_dots_{unit}") for unit in trace_probe.UNITS}
    ptxas_k7 = {lay: ptxas_of(probe_log, f"gather_{lay}") for lay in ("planar", "packed")}
    losses = [ln.strip() for ln in probe_log.splitlines() if "Performance Loss" in ln]

    # K7: the race's entries, each layout bit-equal to the plain version
    planes, packed, flat = g["planes"], g["packed"], g["flat"]
    layouts = {"planar_1": (planes[:1], False), "planar_3": (planes, False),
               "packed": (packed, True)}
    k7 = {}
    for key, (table, pk) in layouts.items():
        for q in (0, 1, 3, 5, 2048, flat.numel()):
            for k in range(4):                   # views 0, 4, 8, 12 bytes off
                idx = flat[k:k + q]
                if not torch.equal(gather_bench.texel_gather(table, idx, pk),
                                   gather_bench.texel_gather_reference(table, idx, pk)):
                    raise AssertionError(f"K7 {key} differs at {q} queries, view {k}")
        out = gather_bench.texel_gather(table, flat, pk)
        if not bits_equal(out, gather_bench.texel_gather(table, flat, pk)):
            raise AssertionError(f"K7 {key}: two launches differ")
        k7[key] = dict(
            ms=dms(lambda: gather_bench.texel_gather(table, flat, pk), 100),
            plain_ms=dms(lambda: gather_bench.texel_gather_reference(
                table, flat, pk), 20),
            bound=bound(4 * (flat.numel() + out.numel() + table.numel()), 0),
            # each random read moves a 32-byte L2 sector to the SM
            l2_sector_bytes=32 * flat.numel() * (1 if pk else table.shape[0]))
    flat64 = flat.long()
    k7["planar_1"]["library_ms"] = dms(lambda: planes[0][flat64], 100)
    k7["planar_3"]["library_ms"] = dms(lambda: planes[:, flat64], 100)
    k7["planar_3"]["plane_flat_x3_ms"] = g["ms"]["torch plane[flat] x3"]
    k7["packed"]["library_ms"] = dms(lambda: packed.index_select(0, flat64), 100)
    if not all(g["correct"].values()):
        raise AssertionError(f"gather race: {g['correct']}")

    # K8a: every mechanism, row, copy count and depth bit-equal to the
    # contract; the in-flight bound n t1 / depth, t1 the depth-1 time per
    # copy at the same mechanism, row and count in this run
    k8a = {}
    for (mech, row_bytes, copies, depth), ms in p2["ms"].items():
        table = p2["table"][:, :row_bytes // 4].contiguous()
        idx = p2["idx"][:copies]
        out = overlap_probe.row_copy(table, idx, mech, depth)
        if not torch.equal(out, overlap_probe.row_copy_reference(table, idx)):
            raise AssertionError(f"K8a {mech} {row_bytes} B x {copies} at depth "
                                 f"{depth} differs")
        k8a[(mech, row_bytes, copies, depth)] = dict(
            ms=ms, ns_per_copy=ms * 1e6 / copies,
            inflight_bound_ms=p2["ms"][(mech, row_bytes, copies, 1)] / depth,
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

    # K8b at 0, 1, 3, 5, 2048 and 921600 queries and on views one int32 off
    # (together, and rows alone), bit-equal; two launches give the same
    # bits; torch indexing and K7 (through L2) beside
    tbl = p3["table"]
    rows_b, cols_b = p3["big"]
    cases = {str(q): (rows_b[:q], cols_b[:q]) for q in (0, 1, 3, 5)}
    cases.update({"2048": p3["small"], "921600": p3["big"],
                  "921599_off1": (rows_b[1:], cols_b[1:]),
                  "921599_rows_off1": (rows_b[1:], cols_b[:-1])})
    for key, (rows, cols) in cases.items():
        out = overlap_probe.dsmem_gather(tbl, rows, cols)
        if not torch.equal(out, overlap_probe.dsmem_gather_reference(tbl, rows, cols)):
            raise AssertionError(f"K8b at {key} queries differs")
    first = overlap_probe.dsmem_gather(tbl, rows_b, cols_b)
    again = overlap_probe.dsmem_gather(tbl, rows_b, cols_b)
    if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("K8b: two launches differ")
    k8b = {}
    for key, (rows, cols), pkey in (("2048", p3["small"], "16x128"),
                                    ("921600", p3["big"], "921600")):
        k8b[key] = dict(
            ms=p3["ms"][pkey],
            plain_ms=dms(lambda: overlap_probe.dsmem_gather_reference(
                tbl, rows, cols), 20),
            library_ms=p3["ms"][f"index_{pkey}"],
            bound=bound(tbl.numel() * 4 + rows.numel() * 12, 0))
    k8b["921600"]["l2_gather_k7_ms"] = p3["ms"]["l2_921600"]
    k8b["921600"]["same_texel_ms"] = p3["ms"]["921600_same_texel"]
    if not all(p3["correct"].values()):
        raise AssertionError(f"P3: {p3['correct']}")

    phase("probes", f"launches {launches}; K6 cuda_core "
          f"{t['ms']['cuda_core']:.4f} ms (plain {plain_k6:.2f}, bound "
          f"{bound_cc[0]:.4f}, --fmad=false issue bound {issue_cc:.4f} at "
          f"{mhz:.0f} MHz, max abs err vs plain {err_k6:.3g}), tensor_core "
          f"{t['ms']['tensor_core']:.4f} ms (bound {bound_tc[0]:.4f}, max rel "
          f"err vs cuda_core {tc_err:.3e}), wgmma {t['ms']['wgmma']:.4f} ms "
          f"(max rel err vs cuda_core {wg_err:.3e}, vs plain {wg_err_plain:.3e});"
          f" K7 " + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in k7.items())
          + f" (plane[flat] {k7['planar_1']['library_ms']:.4f}, planes[:, flat] "
          f"{k7['planar_3']['library_ms']:.4f}, plane[flat] x3 "
          f"{k7['planar_3']['plane_flat_x3_ms']:.4f}, index_select "
          f"(N,4) {k7['packed']['library_ms']:.4f}); ptxas K6 {ptxas_k6}, K7 "
          f"{ptxas_k7}, performance-loss notes {losses or 'none'}; K8a ns/copy at 4096, "
          "depth 1 / 8: " + ", ".join(
              f"{m} {b} B {k8a[(m, b, 4096, 1)]['ns_per_copy']:.1f} / "
              f"{k8a[(m, b, 4096, 8)]['ns_per_copy']:.1f}"
              for m in overlap_probe.MECHANISMS for b in (512, 16))
          + f"; K8b {k8b['2048']['ms']:.4f} ms at 2048 q, "
          f"{k8b['921600']['ms']:.4f} at 921600 (table[rows, cols] "
          f"{k8b['921600']['library_ms']:.4f}, L2 gather K7 "
          f"{p3['ms']['l2_921600']:.4f}); P1 trivial {p1['ms']['trivial']:.4f}"
          f" | kernel A {p1['ms']['kernel']:.4f} | gather "
          f"{p1['ms']['gather']:.4f} | together {p1['ms']['together']:.4f} "
          f"ms, overlap {p1['overlap']}; GPU {gpu}")

    def variants(d):
        return {k: dict({m: v for m, v in row.items() if m != "bound"},
                        bound_ms=row["bound"][0], bound_by=row["bound"][1])
                for k, row in d.items()}

    main_k8a = k8a[("tma", 512, 4096, overlap_probe.SLOTS)]
    k8a_rows = {f"{m}_{b}B_{c}_depth{d}": row for (m, b, c, d), row in k8a.items()
                if d in (1, overlap_probe.SLOTS)}
    return [
        dict(name="trace_dots",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/trace_dots.cu",
             replaces="scripts/mxu_trace_probe.py:77",
             launches=launches["trace_dots"], max_abs_err=err_k6,
             ms=t["ms"]["cuda_core"], plain_ms=plain_k6, bound=bound_cc,
             library_ms=None, launches_by_path={}, ptxas=ptxas_k6,
             variants=variants({
                 "cuda_core": dict(ms=t["ms"]["cuda_core"], bound=bound_cc,
                                   issue_bound_ms=issue_cc, sm_clock_mhz=mhz),
                 "tensor_core": dict(ms=t["ms"]["tensor_core"], bound=bound_tc,
                                     max_rel_err_vs_cuda_core=tc_err),
                 "wgmma": dict(ms=t["ms"]["wgmma"], bound=bound_tc,
                               max_rel_err_vs_cuda_core=wg_err,
                               max_rel_err_vs_plain=wg_err_plain)})),
        dict(name="texel_gather",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/texel_gather.cu",
             replaces="scripts/gather_bench.py:85",
             launches=launches["texel_gather"], max_abs_err=0.0,
             ms=k7["planar_1"]["ms"], plain_ms=k7["planar_1"]["plain_ms"],
             bound=k7["planar_1"]["bound"],
             library_ms=k7["planar_1"]["library_ms"], launches_by_path={},
             ptxas=ptxas_k7, variants=variants(k7)),
        dict(name="row_copy",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/row_copy.cu",
             replaces="scripts/overlap_probe.py:159",
             launches=launches["row_copy"], max_abs_err=0.0,
             ms=main_k8a["ms"], plain_ms=plain_k8a, bound=main_k8a["bound"],
             inflight_bound_ms=main_k8a["inflight_bound_ms"],
             ms_depth1=k8a[("tma", 512, 4096, 1)]["ms"],
             library_ms=lib_k8a, launches_by_path={},
             variants=variants(k8a_rows)),
        dict(name="dsmem_gather",
             source="cpuperformanceraytracer_tpu_torch/csrc/probes/dsmem_gather.cu",
             replaces="scripts/overlap_probe.py:199",
             launches=launches["dsmem_gather"], max_abs_err=0.0,
             ms=k8b["2048"]["ms"], plain_ms=k8b["2048"]["plain_ms"],
             bound=k8b["2048"]["bound"], library_ms=k8b["2048"]["library_ms"],
             launches_by_path={}, variants=variants(k8b)),
    ], dict(p1=p1["ms"], p1_overlap=p1["overlap"],
            p1_gather_queries=p1["queries"])


ORACLE_FRAMES = 4              # oracle frames at 720p (phase 15)


def phase_oracle(dev, scene, cam, tex, glass_cfg) -> dict:
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
    oracle.run()
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

    out, peak_gib = {}, {}
    for name, fn in (("plain", plain_loss), ("replay", replay_loss)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[name] = value_and_grad(fn, params, 1)
        torch.cuda.synchronize()
        peak_gib[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    (lp, gp), (lr, gr) = out["plain"], out["replay"]
    torch.testing.assert_close(lr, lp, rtol=1e-4, atol=1e-7)
    for n in params:
        if not gp[n].abs().max() > 0:
            raise AssertionError(f"path replay: plain {n} gradient is zero")
        torch.testing.assert_close(gr[n], gp[n], rtol=1e-4, atol=1e-7)
    phase("oracle", f"720p glass 8 bounces (wang, env gradient_sky(512,256)) "
          f"over {ORACLE_FRAMES} frames, peak {frame_peak:.2f} GiB; vs kernel "
          f"route {off:.5%} px off; cornell 256x64 vs kernel A route max abs "
          f"err {diffuse_err:.3g}; path replay 320x180 8 bounces bilinear: "
          f"grads equal plain (rtol 1e-4), peak above the inputs plain "
          f"{peak_gib['plain']:.3f} GiB, replay {peak_gib['replay']:.3f} GiB")
    return dict(frames=ORACLE_FRAMES, frame_peak_gib=frame_peak,
                px_off_vs_kernel_route=off, diffuse_max_abs_err=diffuse_err,
                replay_peak_gib=peak_gib["replay"],
                plain_peak_gib=peak_gib["plain"])


SCALING_FRAMES = 64            # frames a world of the scaling harness (phase 16)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_rank(cfg, params, target, device: str) -> dict:
    """Phase 16: one rank of a gloo world of 2 on the one card (px = 2;
    then px = 1 x spp = 2): the frames, two training steps and the
    launches of kernels A-D over them."""
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
    return dict(frames={k: v.cpu() for k, v in frames.items()},
                loss=loss.cpu(), grads={k: g.cpu() for k, g in grads.items()},
                bit_equal_twice=twice, elements=elements, launches=launches)


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


def windows(dev, scene, cam, cfg) -> int:
    """Phase 16: kernels A and C on the lower half of the frame's rows
    (bit-equal to those rows of a whole launch; C twice); returns the
    window's rows."""
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
    )

    h = cfg.height // 2
    half = dict(row0=h, local_height=h)
    tables = pack_tables(scene, cam, cfg, dev)
    full_a = render_planes(tables, cfg, 0)
    win_a = render_planes(tables, cfg, 0, **half)
    ccfg = cfg.replace(rng="counter")
    gen = torch.Generator(device=dev).manual_seed(4)
    cot6 = torch.randn((6, cfg.height, cfg.width), device=dev, generator=gen)
    cwin = cot6[:, h:].contiguous()
    del cot6
    c1 = bwd_tables(tables, ccfg, 1, 0, cwin, **half)
    c2 = bwd_tables(tables, ccfg, 1, 0, cwin, **half)
    sync(dev)
    if not torch.equal(win_a, full_a[:, h:]):
        raise AssertionError("kernel A: the window differs from the whole "
                             "frame's rows")
    if not all(bits_equal(a, b) for a, b in zip(c1, c2)):
        raise AssertionError("kernel C: two window launches differ")
    return h


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

    one = shard.sharded_render_frame(scene, cam, tex, cfg, 3,
                                     make_mesh((1, 1), device=dev))
    if not torch.equal(one, unsharded(cfg)):
        raise AssertionError("a world of 1 differs from the unsharded frame")

    tcfg = cfg.replace(rng="counter")
    params = default_bench_params(scene, tex)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, tcfg, 0)
    loss, grads = loss_and_grad(params, target, scene, cam, tex, tcfg, 1)
    ranks = spawn_world(sharded_rank, 2, (
        cfg, {k: v.cpu() for k, v in params.items()}, target.cpu(),
        dev.type), backend="gloo", timeout=300)
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
    pts = measure_scaling(scene, cam, tex, cfg, device_counts=[1, 2],
                          frames=SCALING_FRAMES, backend="gloo", timeout=300)
    if [p.devices for p in pts] != [1, 2] or not all(
            math.isfinite(p.ms_per_frame) and p.ms_per_frame > 0 for p in pts):
        raise AssertionError(f"scaling harness: {pts}")
    return dict(spp2_max_abs_err=spp_err, loss=ranks[0]["loss"].item(),
                loss_unsharded=loss.item(), grads_rel_l2=rel,
                comm_elements=n_elements, launches=launches)


def phase_parallel(dev, scene, cam, tex, cfg) -> dict:
    """Phase 16: kernels A and C on a row window; the parallel layer. (Its
    first part, the native codec and the profiler trace, runs after phase
    5: in a process where phases 6-15 had run, a CPU + CUDA profile of a
    frame recorded no kernel on the H100 machine.)"""
    rows = windows(dev, scene, cam, cfg)
    w = worlds(dev, scene, cam, tex, cfg)
    phase("parallel", f"A and C on a {rows}-row window: A = the frame's "
          f"rows, C bit-equal twice; world of 1 bit-equal; gloo world of 2 "
          f"on one card: frames wang + counter bit-equal, px 1 x spp 2 max "
          f"abs err {w['spp2_max_abs_err']:.3g}, loss {w['loss']:.7g} vs "
          f"{w['loss_unsharded']:.7g}, grads rel L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in w["grads_rel_l2"].items())
          + f", two steps bit-equal, {w['comm_elements']} elements = budget; "
          f"launches {w['launches']}; the scaling harness ran worlds of 1 "
          f"and 2")
    return dict(window_rows=rows, world2=w)


def phase_drivers(dev) -> dict:
    """Phase 17: the drivers of configs 5 and 4, the headline bench and
    the T ~ P training step (see the module docstring)."""
    import os

    from cpuperformanceraytracer_tpu_torch import bench
    from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import fwd_bwd_benchmark
    from cpuperformanceraytracer_tpu_torch.diff.grad import (
        loss_and_grad,
        render_for_params,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.adam import adam
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.kernels.deflate import deflate
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_backward import env_backward
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
        render_planes_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.tonemap import tonemap
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.render.frame import frame_blend
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.scripts.inverse_env_demo import (
        DEMO,
        initial_params,
        inverse_env,
    )
    from cpuperformanceraytracer_tpu_torch.scripts.run_offline_4k import (
        run_offline,
    )
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    kernels = {"render_planes": render_planes, "env_accumulate": env_accumulate,
               "bwd_tables": bwd_tables, "env_backward": env_backward,
               "tonemap": tonemap, "adam": adam, "deflate": deflate}

    def counted(path, fn, need):
        """``fn()`` with the kernels' launch counts set to 0 just before it
        and read just after; every kernel in ``need`` must have launched."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        if not all(launches[n] > 0 for n in need):
            raise AssertionError(f"{path}: launches {launches}, need {need}")
        return out, launches

    sky = gradient_sky(512, 256)
    tex = texture_from_array(sky)
    tex_dev = texture_from_array(sky, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    launches, held = {}, {}

    # config 5: 4K x 1024 frames, a checkpoint every 128, resumed
    cfg = BENCH_CONFIGS["offline_4k"]
    (off, state), launches["offline_4k"] = counted(
        "offline_4k", lambda: run_offline(
            cfg, tex, os.path.join(OUT_DIR, "offline_4k.png")),
        ("render_planes", "env_accumulate", "tonemap", "deflate"))
    whole = OfflineRenderer(cfg, texture=tex, silent=True)
    whole.run()
    if not torch.equal(state.accum, whole.accum):
        raise AssertionError("offline_4k: the resumed accumulator differs "
                             "from the uninterrupted run's")
    if state.frame != cfg.num_frames or not torch.isfinite(state.accum).all() \
            or state.accum.mean().item() <= 0.0:
        raise AssertionError(f"offline_4k: frame {state.frame}, accum mean "
                             f"{state.accum.mean().item()}")
    # kernel G on the 4K accumulator; kernels A and B on one 4K frame
    held["G_4k"] = dict(zip(("max_abs_err", "u8_equal", "u8_max_off"),
                            hold_tonemap(state.accum, "offline_4k accumulator")))
    held["deflate_4k"] = hold_deflate(state.accum, "offline_4k accumulator")
    del state, whole
    scene, cam = scene_by_name(cfg.scene, device=dev)
    tables = pack_tables(scene, cam, cfg, dev)
    planes = render_planes(tables, cfg, 1)
    planes_ref = render_planes_reference(tables, cfg, 1)
    off4k, worst = hold_planes(planes, planes_ref, "kernel A 4K")
    accum0 = torch.rand((3, cfg.height, cfg.width), device=dev,
                        generator=gen) * 3.0
    same, err_b, chain_off, _ = hold_env_accumulate(
        planes, planes_ref, tex_dev, cfg, accum0, frame_blend(3),
        "kernel B 4K")
    held["A_4k"] = {"worst_plane": worst, "share_off": off4k[worst],
                    "missed_share_off": off4k["missed"],
                    "rgb_max_abs_err": (planes[:3] - planes_ref[:3])
                    .abs().max().item()}
    held["B_4k"] = {"indices_equal": same, "max_abs_err": err_b,
                    "chain_share_off": chain_off}
    del planes, planes_ref, accum0
    off = {k: off[k] for k in ("frames_total", "resumed_at_frame", "device")}
    phase("drivers", f"offline_4k {cfg.width}x{cfg.height} x "
          f"{off['frames_total']} frames, "
          f"resumed at {off['resumed_at_frame']}, bit-equal to one "
          f"uninterrupted run; launches {launches['offline_4k']}; one 4K frame: A vs plain (worst "
          f"{worst} {off4k[worst]:.5%} px off), B indices equal on "
          f"{same:.5%}, A->B vs plain chain {chain_off:.5%} px off; G on the "
          f"4K accumulator max abs err {held['G_4k']['max_abs_err']:.3g}, u8 "
          f"equal on {held['G_4k']['u8_equal']:.5%}; the deflate on its "
          f"planes: the first {DEFLATE_CUT} bytes of each equal to the "
          f"plain version's ({held['deflate_4k']['bytes_off']} bytes off), "
          f"the whole planes inflate bit-equal, "
          f"{held['deflate_4k']['written_bytes']} bytes written")

    # config 4: albedos and all 131072 texels at 256x144, 200 steps
    inv, launches["env_inverse"] = counted(
        "env_inverse", lambda: inverse_env(DEMO, tex),
        ("render_planes", "env_accumulate", "bwd_tables", "env_backward",
         "adam"))
    if not (inv["loss_last"] < inv["loss_first"] and inv["params_finite"]):
        raise AssertionError(f"env inverse: loss {inv['loss_first']} -> "
                             f"{inv['loss_last']}, finite "
                             f"{inv['params_finite']}")
    # one step's gradients at the demo's start (A-D at spp 2, 3 bounces,
    # T > P) against the plain path's on the card, phase 8's rule
    scene, cam = scene_by_name(DEMO.scene, device=dev)
    init = initial_params(scene, tex_dev)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex_dev, DEMO, 0)
    _, got = loss_and_grad(init, target, scene, cam, tex_dev, DEMO, 0)
    _, want = loss_and_grad(init, target, scene, cam, tex_dev,
                            DEMO.replace(backend="torch"), 0)
    held["inverse_grads_rel_l2"] = {n: rel_l2(got[n], want[n]) for n in init}
    if max(held["inverse_grads_rel_l2"].values()) >= 2e-2 or not all(
            torch.isfinite(v).all() and v.norm() > 0 for v in got.values()):
        raise AssertionError(f"env inverse gradients vs plain path: "
                             f"{held['inverse_grads_rel_l2']}")
    del got, want
    # the same 200 steps on the plain path on the card, torch's own Adam
    plain, plain_launches = counted(
        "env_inverse_plain", lambda: inverse_env(
            DEMO.replace(backend="torch"), tex, warm_chunks=0,
            timed_chunks=1, device=dev), ())
    if any(plain_launches.values()):
        raise AssertionError(f"env inverse, plain path: kernels launched "
                             f"{plain_launches}")
    if not (plain["loss_last"] < plain["loss_first"]
            and plain["params_finite"]):
        raise AssertionError(f"env inverse, plain path: loss "
                             f"{plain['loss_first']} -> {plain['loss_last']}")
    loss_dev = max(abs(a - b) / abs(b) for a, b in zip(inv["losses"],
                                                       plain["losses"]))
    albedo_dev = (inv["params"]["albedo"] - plain["params"]["albedo"]
                  ).abs().max().item()
    if not (loss_dev < 1e-4 and albedo_dev < 1e-4):
        raise AssertionError(f"env inverse: the kernels' 200 steps leave the "
                             f"plain path's: losses within {loss_dev:.3e} "
                             f"relative, albedos within {albedo_dev:.3e}")
    held["inverse_vs_plain_path"] = {
        "loss_max_rel_dev": loss_dev, "albedo_max_abs_dev": albedo_dev,
        "plain_loss_last": plain["loss_last"],
        "plain_albedo_err_by_material": plain["albedo_err_by_material"]}
    inv = {k: v for k, v in inv.items() if k not in (
        "params", "losses", "ms_per_step_incl_compile", "ms_per_step_steady",
        "steady_steps")}
    phase("drivers", f"env inverse {inv['config']}, {inv['steps']} steps at "
          f"K = {inv['steps_per_dispatch']}: loss {inv['loss_first']:.6f} -> "
          f"{inv['loss_last']:.6f}, albedo max err "
          f"{inv['albedo_max_err']:.4f}, finite; launches "
          f"{launches['env_inverse']}; albedo err by material "
          + ", ".join(f"{e:.4f}" for e in inv["albedo_err_by_material"])
          + "; one step's gradients vs plain path relative L2 "
          + ", ".join(f"{n} {v:.3e}" for n, v in
                      held["inverse_grads_rel_l2"].items())
          + f"; the plain path's 200 steps: loss -> {plain['loss_last']:.6f}"
          f", albedo err by material "
          + ", ".join(f"{e:.4f}" for e in plain["albedo_err_by_material"])
          + f"; kernels vs plain path: losses within {loss_dev:.3e} "
          f"relative, albedos within {albedo_dev:.3e}")
    del plain

    # the headline: bench.py's line
    head, launches["headline"] = counted(
        "headline", lambda: bench.headline(bench.HEADLINE, tex),
        ("render_planes", "env_accumulate", "bwd_tables", "env_backward"))
    if not head["fwd_bwd_grads_finite"]:
        raise AssertionError("headline: gradients not finite")
    head = {k: head[k] for k in ("metric", "device", "fwd_bwd_grads_finite")}
    phase("drivers", f"headline {head['metric']}: gradients finite; launches "
          f"{launches['headline']}")

    # config 3's regime: T ~ P (a 2048x1024 env at 720p)
    big = texture_from_array(gradient_sky(2048, 1024), dev)
    tcfg = bench.HEADLINE.replace(rng="counter", num_frames=1)
    scene, cam = scene_by_name(tcfg.scene, device=dev)
    tp, launches["t_eq_p_step"] = counted(
        "t_eq_p_step", lambda: fwd_bwd_benchmark(
            tcfg, scene, cam, big, steps=STEPS,
            steps_per_dispatch=STEPS_PER_DISPATCH),
        ("render_planes", "env_accumulate", "bwd_tables", "env_backward"))
    if not tp["grads_finite"]:
        raise AssertionError("T ~ P step: gradients not finite")
    # kernel D at T ~ P: the 720p planes' texel indices into the 2k env
    tables = pack_tables(scene, cam, tcfg, dev)
    planes = render_planes(tables, tcfg, 1)
    idx = torch.empty((tcfg.height, tcfg.width), dtype=torch.int64,
                      device=dev)
    env_accumulate(planes, big, tcfg,
                   torch.zeros((3, tcfg.height, tcfg.width), device=dev),
                   frame_blend(0), index_out=idx)
    g = torch.randn((3, tcfg.height, tcfg.width), device=dev, generator=gen)
    d = hold_env_backward(g, idx, planes[6:9], big, "kernel D T ~ P")
    held["D_t_eq_p"] = {"max_abs_err": d["max_err"],
                        "worst_over_bound": d["worst"],
                        "over_fixed": d["over_fixed"]}
    del planes, d
    tp = {"steps_per_dispatch": tp["steps_per_dispatch"], "loss": tp["loss"],
          "texels": big.width * big.height,
          "pixels": tcfg.width * tcfg.height}
    phase("drivers", f"T ~ P step ({tcfg.width}x{tcfg.height}, env "
          f"{big.width}x{big.height}: {tp['texels']} texels, {tp['pixels']} "
          f"pixels), K = {tp['steps_per_dispatch']}: gradients finite; "
          f"launches {launches['t_eq_p_step']}; kernel D at these shapes: cot_mt "
          f"equal, two calls bit-equal, texel sums within "
          f"{held['D_t_eq_p']['worst_over_bound']:.3g} of the "
          f"(k-1)*2^-24*sum|v| bound (max abs err "
          f"{held['D_t_eq_p']['max_abs_err']:.3g})")
    return dict(offline_4k=off, env_inverse=inv, headline=head,
                t_eq_p_step=tp, launches=launches, held=held)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.kernels import _build
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
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
    planes_ref = render_planes_reference(tables, cfg, 0)
    torch.cuda.synchronize()
    off, worst = hold_planes(planes, planes_ref, "kernel A")
    glass_err = (planes[:3] - planes_ref[:3]).abs().max().item()
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    render_planes(tables, cfg, 0, lane_stats=stats)
    util_a = stats[0].item() / stats[1].item()
    per_sm, sms = resident_blocks(tables)
    regs_a = ptxas_of(builds[0].log, "render_planes_kernel")
    phase("kernel A", f"cornell strict ok (max abs err {max_err_a:.3g}); "
          f"glass 1280x720 robust ok on 12 planes (worst {worst} "
          f"{off[worst]:.5%} px off; missed flags differ on "
          f"{off['missed']:.5%}; rgb max abs err {glass_err:.3g}); lane "
          f"utilisation {util_a:.4f}; {per_sm} blocks per SM x {sms} SMs; "
          f"ptxas: {regs_a}")

    # ---- phase 4: kernel B vs plain on the same planes ------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    accum0 = torch.rand((3, 720, 1280), device=dev, generator=gen) * 3.0
    same_share, err_b, chain_off, gi = hold_env_accumulate(
        planes, planes_ref, tex, cfg, accum0, frame_blend(3), "kernel B")
    del planes_ref, accum0
    phase("kernel B", f"indices equal on {same_share:.5%}; accum allclose "
          f"(max abs err {err_b:.3g}); chain A->B vs plain chain "
          f"{chain_off:.5%} px off")

    # ---- phase 5: the main path -----------------------------------------
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam, silent=True)
    render_planes.launches = 0
    env_accumulate.launches = 0
    r.run()
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
    del plain
    phase("main path", f"1280x720 glass_spheres 8 bounces, env "
          f"gradient_sky(512,256): launches {launches}; image mean "
          f"{img.mean():.2f}; accum vs plain path {main_off:.5%} px off")

    # ---- phase 16, first part: the native codec, a profiler trace --------
    native_and_trace(dev, scene, cam, tex, cfg)
    phase("parallel", "native codec = numpy path (make -C native); a "
          "profiler trace of one forward frame names kernel A")

    # ---- phases 6-8 --------------------------------------------------------
    c = phase_kernel_c(dev, tables, cfg, builds[0].log)
    d = phase_kernel_d(dev, planes, gi, tex)
    t = phase_training(dev, scene, cam, tex, cfg)
    adam_numbers = phase_kernel_adam(dev)

    # ---- phases 9-13: the textured multi-sample path ---------------------
    err_e = phase_kernel_e(dev, planes, cfg, tex)
    err_f = phase_kernel_f(dev)
    err_g = phase_kernel_g(dev, accum)
    x = phase_textured(dev)
    phase_checkpoint(dev)

    # ---- phase 14: the probes --------------------------------------------
    probe_rows, probes = phase_probes(dev, gpu, builds[1].log)

    # ---- phase 15: the oracle integrator ----------------------------------
    o = phase_oracle(dev, scene, cam, tex, cfg)

    # ---- phase 16: the parallel layer, windows ----------------------------
    par = phase_parallel(dev, scene, cam, tex, cfg)

    # ---- phase 17: the drivers of configs 5 and 4, the headline ----------
    drv = phase_drivers(dev)

    # ---- the kernels' numbers ---------------------------------------------
    def drv_launches(kernel: str) -> dict:
        """A kernel's launches on each driver of phase 17."""
        return {path: n[kernel] for path, n in drv["launches"].items()}

    def train_launches(kernel: str) -> dict:
        """A kernel's launches on the training paths of phases 8 and 16."""
        return {"training": t["launches"][kernel],
                "training_k1": t["launches_k1"][kernel],
                "sharded_2_ranks": par["world2"]["launches"][kernel]}

    rows = [
        dict(name="megakernel",
             source="cpuperformanceraytracer_tpu_torch/csrc/megakernel.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/megakernel.py:251",
             launches=launches["render_planes"], max_abs_err=glass_err,
             launches_by_path={"forward": launches["render_planes"],
                               **train_launches("render_planes"),
                               **drv_launches("render_planes")},
             lane_utilisation=util_a, resident_blocks_per_sm=per_sm,
             ptxas=regs_a),
        dict(name="env_accumulate",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_accumulate.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/megakernel.py:1162",
             launches=launches["env_accumulate"], max_abs_err=err_b,
             launches_by_path={"forward": launches["env_accumulate"],
                               **train_launches("env_accumulate"),
                               **drv_launches("env_accumulate")}),
        dict(name="bwd_tables",
             source="cpuperformanceraytracer_tpu_torch/csrc/backward.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/backward.py:230",
             launches=t["launches"]["bwd_tables"],
             launches_by_path={**train_launches("bwd_tables"),
                               **drv_launches("bwd_tables")},
             **c),
        dict(name="env_backward",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_backward.cu",
             replaces="cpuperformanceraytracer_tpu/diff/segsum.py:46",
             launches=t["launches"]["env_backward"],
             launches_by_path={**train_launches("env_backward"),
                               **drv_launches("env_backward")},
             **d),
        dict(name="env_gather",
             source="cpuperformanceraytracer_tpu_torch/csrc/env_gather.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/env_gather.py:102",
             launches=x["launches"]["env_lookup"],
             max_abs_err=max(err_e, x["err_e"])),
        dict(name="combine",
             source="cpuperformanceraytracer_tpu_torch/csrc/combine.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/combine.py:148",
             launches=x["launches"]["combine_accumulate"], max_abs_err=err_f),
        dict(name="tonemap",
             source="cpuperformanceraytracer_tpu_torch/csrc/tonemap.cu",
             replaces="cpuperformanceraytracer_tpu/kernels/tonemap.py:46",
             launches=x["launches"]["tonemap"], max_abs_err=err_g,
             launches_by_path={"textured": x["launches"]["tonemap"],
                               **drv_launches("tonemap")}),
        dict(name="deflate",
             source="cpuperformanceraytracer_tpu_torch/csrc/deflate.cu",
             replaces=None, launches=drv["held"]["deflate_4k"]["launches"],
             max_abs_err=drv["held"]["deflate_4k"]["bytes_off"],
             launches_by_path=drv_launches("deflate"),
             bound_ms=drv["held"]["deflate_4k"]["bound"][0],
             bound_by=drv["held"]["deflate_4k"]["bound"][1]),
        *(dict(name=f"adam_{cell}",
               source="cpuperformanceraytracer_tpu_torch/csrc/adam.cu",
               replaces=None, max_abs_err=0.0,
               launches_by_path={**t["adam_launches"],
                                 **drv_launches("adam")}, **numbers)
          for cell, numbers in adam_numbers.items()),
    ]
    for r in probe_rows:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    for r in rows + probe_rows:
        r["route"] = "cuda"
    print(json.dumps({"kernels": rows + probe_rows,
                      "training_path": t["summary"],
                      "textured_path": x["summary"],
                      "oracle": o, "probes": probes, "parallel": par,
                      "drivers": drv}))
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
