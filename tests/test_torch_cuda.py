"""The port's CUDA kernels vs their plain-torch versions on the card.

Every test needs a GPU (marker ``cuda``) and skips without one. The file
imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Strict tolerances (rtol 1e-4, atol 1e-5) hold for the diffuse cornell
box; the glass scene is held to the robust policy (a 1-ulp difference in
expf/atan2f can flip a lottery roll). Table cotangents of kernel C are
sums over pixels taken in another order than autograd's (a fixed order
of its own): rtol 1e-3 with atol 1e-3 of the largest cotangent.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401  (fixture)
    cuda_device,
    kernel_d_order,
    port_beer_scene,
)
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff.benchgrad import default_bench_params
from cpuperformanceraytracer_tpu_torch.diff.grad import loss_and_grad, render_for_params
from cpuperformanceraytracer_tpu_torch.kernels.backward import (
    bwd_tables,
    bwd_tables_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.combine import (
    combine_accumulate,
    combine_accumulate_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
    env_accumulate,
    env_accumulate_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_backward import (
    env_backward,
    env_backward_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_gather import (
    env_lookup,
    env_lookup_reference,
    gather_texels,
    gather_texels_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    pack_tables,
    plane_mismatch,
    render_planes,
    render_planes_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.tonemap import (
    tonemap,
    tonemap_reference,
)
from cpuperformanceraytracer_tpu_torch.probes import (
    gather_bench,
    overlap_probe,
    trace_probe,
)
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.render.frame import frame_blend
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

pytestmark = pytest.mark.cuda


def _robust(a, b):
    a, b = a.double(), b.double()
    assert abs(a.mean() - b.mean()) < 1e-2 * max(b.mean().abs().item(), 1e-3)
    assert ((a - b).abs() > 1e-3).double().mean() < 0.02


def _tables(name, cfg, dev):
    return pack_tables(*scene_by_name(name, device=dev), cfg, dev)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("roulette", ["off", "terminate", "v4_quirk"])
@pytest.mark.parametrize("rng,sampler", [("wang", "normalized3"),
                                         ("counter", "normalized3"),
                                         ("wang", "zangle")])
def test_megakernel_cornell_strict(cuda_device, rng, sampler, roulette,
                                   early_exit):
    # early_exit only mirrors the JAX config: both values give the planes
    # of the plain version
    cfg = RenderConfig(width=128, height=32, bounces=3, spp=2,
                       scene="cornell_box", env_mode="none", rng=rng,
                       unit_vector_sampler=sampler, roulette=roulette,
                       early_exit=early_exit)
    tables = _tables("cornell_box", cfg, cuda_device)
    got = render_planes(tables, cfg, 7, sample0=1)
    want = render_planes_reference(tables, cfg, 7, sample0=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("env_mode", ["equirect", "none"])
def test_megakernel_glass_robust(cuda_device, env_mode):
    cfg = RenderConfig(width=256, height=64, bounces=4, scene="glass_spheres",
                       env_mode=env_mode)
    tables = _tables("glass_spheres", cfg, cuda_device)
    got = render_planes(tables, cfg, 2)
    want = render_planes_reference(tables, cfg, 2)
    torch.cuda.synchronize()
    for c in (0, 1, 2, 6, 7, 8):
        _robust(got[c], want[c])
    # all 12 planes, the miss direction and env jitter included
    off = plane_mismatch(got, want)
    assert max(off.values()) < 1e-3, off


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("sampling", ["stochastic", "nearest"])
def test_env_accumulate_matches_plain(cuda_device, sampling, flip):
    dev = cuda_device
    cfg = RenderConfig(width=256, height=64, bounces=4, env_sampling=sampling,
                       env_flip_xz=flip)
    planes = render_planes_reference(_tables("glass_spheres", cfg, dev), cfg, 0)
    tex = texture_from_array(gradient_sky(512, 256), dev)
    got = torch.rand((3, 64, 256), device=dev)
    want = got.clone()
    gi = torch.empty((64, 256), dtype=torch.int64, device=dev)
    wi = torch.empty_like(gi)
    env_accumulate(planes, tex, cfg, got, frame_blend(5), index_out=gi)
    env_accumulate_reference(planes, tex, cfg, want, frame_blend(5),
                             index_out=wi)
    torch.cuda.synchronize()
    same = gi == wi
    assert same.double().mean() >= 0.999
    torch.testing.assert_close(got[:, same], want[:, same], rtol=1e-5, atol=0)


def test_env_accumulate_env_none(cuda_device):
    cfg = RenderConfig(width=64, height=16, env_mode="none")
    planes = torch.rand((12, 16, 64), device=cuda_device)
    got = torch.rand((3, 16, 64), device=cuda_device)
    want = got.clone()
    env_accumulate(planes, None, cfg, got, 0.25)
    env_accumulate_reference(planes, None, cfg, want, 0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name,env", [("cornell_box", "none"),
                                      ("glass_spheres", "equirect")])
def test_frame_path_counts_launches(cuda_device, name, env):
    cfg = RenderConfig(width=128, height=32, bounces=3, scene=name,
                       env_mode=env, num_frames=4, warmup_frames=1,
                       backend="cuda")
    tex = texture_from_array(gradient_sky(64, 32)) if env != "none" else None
    r = OfflineRenderer(cfg, texture=tex)
    plain = OfflineRenderer(cfg.replace(backend="torch"), texture=tex,
                            device=cuda_device)
    a0, b0 = render_planes.launches, env_accumulate.launches
    r.run()
    assert render_planes.launches - a0 == 5
    assert env_accumulate.launches - b0 == 5
    for _ in range(4):
        plain.step()
    torch.cuda.synchronize()
    if name == "cornell_box":
        torch.testing.assert_close(r.accum, plain.accum, rtol=1e-4, atol=1e-5)
    else:
        for c in range(3):
            _robust(r.accum[c], plain.accum[c])


def test_counter_multisample_env(cuda_device):
    cfg = RenderConfig(width=128, height=32, bounces=3, spp=3, rng="counter",
                       num_frames=2, warmup_frames=0, backend="cuda")
    tex = texture_from_array(gradient_sky(64, 32))
    r = OfflineRenderer(cfg, texture=tex)
    plain = OfflineRenderer(cfg.replace(backend="torch"), texture=tex,
                            device=cuda_device)
    for _ in range(2):
        r.step()
        plain.step()
    torch.cuda.synchronize()
    for c in range(3):
        _robust(r.accum[c], plain.accum[c])


def test_wrappers_reject_bad_inputs(cuda_device):
    cfg = RenderConfig(width=64, height=16, env_mode="none")
    tables = _tables("cornell_box", cfg, cuda_device)
    with pytest.raises(ValueError):
        render_planes((tables[0].t().contiguous().t(),) + tables[1:], cfg, 0)
    with pytest.raises(ValueError):
        render_planes((tables[0].double(),) + tables[1:], cfg, 0)
    planes = render_planes(tables, cfg, 0)
    with pytest.raises(ValueError):
        env_accumulate(planes, None, cfg, torch.zeros((3, 8, 64),
                                                      device=cuda_device))


def _cot6(cfg, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((6, cfg.height, cfg.width), device=dev, generator=gen)


@pytest.mark.parametrize("roulette", ["off", "terminate", "v4_quirk"])
@pytest.mark.parametrize("case", ["beer", "cornell"])
def test_bwd_tables_matches_plain(cuda_device, case, roulette):
    dev = cuda_device
    if case == "beer":
        scene, cam = port_beer_scene(dev)
        cfg = RenderConfig(width=128, height=32, bounces=4, rng="counter",
                           roulette=roulette)
    else:
        scene, cam = scene_by_name("cornell_box", device=dev)
        cfg = RenderConfig(width=128, height=32, bounces=2, rng="counter",
                           scene="cornell_box", env_mode="none",
                           roulette=roulette, unit_vector_sampler="zangle")
    tables = pack_tables(scene, cam, cfg, dev)
    cot6 = _cot6(cfg, dev)
    n0 = bwd_tables.launches
    got = bwd_tables(tables, cfg, 1, 0, cot6)
    want = bwd_tables_reference(tables, cfg, 1, 0, cot6)
    torch.cuda.synchronize()
    assert bwd_tables.launches == n0 + 1
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * scale)
    if case == "beer":
        assert want[1].abs().max() > 0 and want[3][:5].abs().max() > 0


def test_env_backward_matches_plain(cuda_device):
    dev = cuda_device
    tex = texture_from_array(gradient_sky(64, 32), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((3, 64, 128), device=dev, generator=gen)
    mt = torch.rand((3, 64, 128), device=dev, generator=gen)
    idx = torch.randint(0, 64 * 32, (64, 128), device=dev, generator=gen)
    n0 = env_backward.launches
    cot, d = env_backward(g, idx, mt, tex)
    cot_w, d_w = env_backward_reference(g, idx, mt, tex)
    torch.cuda.synchronize()
    assert env_backward.launches == n0 + 1
    assert torch.equal(cot, cot_w)
    for a, b in zip(d, d_w):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _texel_sums_within_bound(d, g, idx, mt):
    """Each texel's sum of k addends within (k - 1) * 2^-24 * sum|v| (at
    least 8 * 2^-24 * sum|v|) of a float64 sum, plus 2^-126 per add (f32
    atomics flush subnormals): the bound of chip_smoke.py's phase 7. A
    texel with a NaN addend is NaN on both sides."""
    flat = idx.reshape(-1)
    n_tex = d[0].numel()
    count = torch.bincount(flat, minlength=n_tex).double()
    allow = torch.clamp(count - 1.0, min=8.0) * 2.0 ** -24
    for c in range(3):
        v = (g[c] * mt[c]).reshape(-1).double()
        exact = torch.zeros(n_tex, dtype=torch.float64, device=v.device)
        exact.index_add_(0, flat, v)
        mag = torch.zeros_like(exact).index_add_(0, flat, v.abs())
        got = d[c].double()
        assert torch.equal(got.isnan(), exact.isnan()), c
        ok = ~exact.isnan()
        err = (got[ok] - exact[ok]).abs()
        assert (err <= allow[ok] * mag[ok] + 2.0 * count[ok] * 2.0 ** -126).all(), c


def _kernel_d_inputs(case, dev):
    rng = np.random.default_rng(11)
    h, w, n_tex = (7, 37, 64) if case == "ragged" else (32, 256, 512)
    idx = rng.integers(0, n_tex, (h, w))
    g = rng.standard_normal((3, h, w)).astype(np.float32)
    mt = rng.random((3, h, w)).astype(np.float32)
    if case == "one_texel":
        idx[:] = 5
    elif case == "alternating":
        idx = np.broadcast_to(np.arange(w) % 2 * 7, (h, w)).copy()
    elif case == "runs":  # runs of random lengths, as a frame's neighbouring pixels
        idx = np.repeat(rng.integers(0, n_tex, h * w), rng.integers(1, 40, h * w))
        idx = idx[:h * w].reshape(h, w)
    elif case == "zero_mt":
        mt[:] = 0.0
    elif case == "signed_zeros_nan":
        mt[:, :, ::3] = 0.0
        mt[:, :, 1::3] = -0.0
        mt[1, 3, 4] = np.nan
        idx[3, 4] = idx[0, 0]
    tex = texture_from_array(rng.random((n_tex // 8, 8, 3)).astype(np.float32), dev)
    return (torch.from_numpy(g).to(dev), torch.from_numpy(idx).to(dev),
            torch.from_numpy(mt).to(dev), tex)


@pytest.mark.parametrize("case", ["one_texel", "alternating", "random", "runs",
                                  "zero_mt", "signed_zeros_nan", "ragged"])
def test_env_backward_warp_sums(cuda_device, case):
    """Kernel D's warp-aggregated, zero-skipping scatter vs its plain
    version: cot_mt equal, texel sums within the k-term bound. ``ragged``
    has 7x37 pixels: not a multiple of 4 (the scalar loads) nor of 32."""
    g, idx, mt, tex = _kernel_d_inputs(case, cuda_device)
    cot, d = env_backward(g, idx, mt, tex)
    cot_w, d_w = env_backward_reference(g, idx, mt, tex)
    torch.cuda.synchronize()
    assert torch.equal(cot, cot_w)
    _texel_sums_within_bound(d, g, idx, mt)
    for a, b in zip(d, d_w):
        assert torch.equal(a.isnan(), b.isnan())
        assert not torch.signbit(a[a == 0]).any()  # never -0.0
    if case == "zero_mt":
        assert not any(x.any() for x in d)


@pytest.mark.parametrize("rng", ["wang", "counter"])
@pytest.mark.parametrize("hw,spp", [((32, 128), 1), ((7, 45), 2), ((4, 8), 1),
                                    ((3, 5), 3), ((32, 256), 3)])
def test_megakernel_regenerating_bit_equal(cuda_device, hw, spp, rng):
    """The persistent kernel A on the diffuse cornell box: all 12 planes
    bit-equal to the plain version, at sizes that are no multiple of 32
    or 4, below one wave of the persistent grid (4x8 and 3x5 pixels), and
    at spp > 1 with the wang stream (a dead sample still takes its
    draws)."""
    h, w = hw
    cfg = RenderConfig(width=w, height=h, bounces=3, spp=spp,
                       scene="cornell_box", env_mode="none", rng=rng)
    tables = _tables("cornell_box", cfg, cuda_device)
    got = render_planes(tables, cfg, 4, sample0=2)
    want = render_planes_reference(tables, cfg, 4, sample0=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_megakernel_launches_in_a_row(cuda_device):
    """The work counter is reset on the stream for every launch: launches
    back to back, into one buffer and into two, each equal to the plain
    version; lane_stats counts a utilisation in (0, 1]."""
    cfg = RenderConfig(width=96, height=32, bounces=3, spp=2,
                       scene="cornell_box", env_mode="none", rng="wang")
    tables = _tables("cornell_box", cfg, cuda_device)
    outs = torch.full((3, 12, 32, 96), -7.0, device=cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    n0 = render_planes.launches
    for frame, slot in ((1, 0), (2, 1), (2, 2)):
        render_planes(tables, cfg, frame, out=outs[slot], lane_stats=stats)
    torch.cuda.synchronize()
    assert render_planes.launches == n0 + 3
    assert torch.equal(outs[0], render_planes_reference(tables, cfg, 1))
    assert torch.equal(outs[1], render_planes_reference(tables, cfg, 2))
    assert torch.equal(outs[1], outs[2])
    live, slots = stats.tolist()
    assert 0 < live <= slots and slots % 32 == 0


def test_render_frame_diff_matches_plain(cuda_device):
    """The training step's gradients on the kernels vs the plain-torch
    path on the card, by per-key norms (a lottery flip may move one path)."""
    tex = texture_from_array(gradient_sky(64, 32), cuda_device)
    scene, cam = scene_by_name("glass_spheres", device=cuda_device)
    cfg = RenderConfig(width=256, height=64, bounces=3, rng="counter", spp=2)
    params = default_bench_params(scene, tex)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    lc, gc = loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    lt, gt = loss_and_grad(params, target, scene, cam, tex,
                           cfg.replace(backend="torch"), 1)
    assert abs(lc.item() - lt.item()) <= 1e-3 * abs(lt.item())
    for k in params:
        assert torch.isfinite(gc[k]).all(), k
        na, nb = gt[k].norm().item(), gc[k].norm().item()
        assert na > 0 and abs(na - nb) <= 0.05 * na, (k, na, nb)


# ---- kernels E, F, G and the textured multi-sample route ----------------

def _env_texture(env_mode, dev):
    if env_mode == "cubemap":
        return texture_from_array(np.concatenate(
            [gradient_sky(32, 32, seed=i) for i in range(6)]), dev)
    return texture_from_array(gradient_sky(128, 64), dev)


@pytest.mark.parametrize("env_mode", ["equirect", "cubemap"])
@pytest.mark.parametrize("sampling", ["stochastic", "nearest", "bilinear"])
def test_env_lookup_matches_plain(cuda_device, env_mode, sampling):
    """Taps equal on >= 99.9% of pixels (atan2f/asinf may sit an ulp from
    torch's), the rows equal to rtol 1e-6 where the taps agree."""
    cfg = RenderConfig(width=256, height=64, bounces=3, rng="counter",
                       env_mode=env_mode, env_sampling=sampling)
    tex = _env_texture(env_mode, cuda_device)
    planes = render_planes(_tables("glass_spheres", cfg, cuda_device), cfg, 2)
    n = cfg.width * cfg.height
    taps = torch.empty((n, 4), dtype=torch.int64, device=cuda_device)
    taps_w = torch.empty_like(taps)
    out = torch.full((2, n, 4), -1.0, device=cuda_device)
    n0 = env_lookup.launches
    got = env_lookup(planes, tex, cfg, out=out[1], taps_out=taps)
    want = env_lookup_reference(planes, tex, cfg, taps_out=taps_w)
    torch.cuda.synchronize()
    assert env_lookup.launches == n0 + 1 and (out[0] == -1.0).all()
    same = (taps == taps_w).all(-1)
    assert same.double().mean() >= 0.999
    torch.testing.assert_close(got[same], want[same], rtol=1e-6, atol=1e-7)
    assert (got[:, 3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_texels_bit_equal(cuda_device, dtype):
    tex = texture_from_array(gradient_sky(96, 48), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rows = torch.randint(-4, 52, (5000,), device=cuda_device, generator=gen,
                         dtype=dtype)
    cols = torch.randint(-4, 100, (5000,), device=cuda_device, generator=gen,
                         dtype=dtype)
    got = gather_texels(tex, rows, cols)
    assert torch.equal(got, gather_texels_reference(tex, rows, cols))


@pytest.mark.parametrize("spp", [1, 3])
def test_combine_matches_plain(cuda_device, spp):
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(spp)
    h, w = 48, 80
    planes = torch.rand((spp, 12, h, w), device=dev, generator=gen)
    e4 = torch.rand((spp, h * w, 4), device=dev, generator=gen)
    acc = torch.rand((3, h, w), device=dev, generator=gen)
    if spp == 1:
        args = (e4[0], planes[0, 0:3], planes[0, 6:9])
    else:
        args = (e4, planes[:, 0:3], planes[:, 6:9])
    n0 = combine_accumulate.launches
    got = combine_accumulate(*args, acc.clone(), 0.2)
    want = combine_accumulate_reference(*args, acc.clone(), 0.2)
    torch.cuda.synchronize()
    assert combine_accumulate.launches == n0 + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_tonemap_matches_plain(cuda_device):
    from cpuperformanceraytracer_tpu_torch.core.color import to_u8
    from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    acc = torch.rand((3, 37, 53), device=cuda_device, generator=gen) * 4
    acc[0, 0, :4] = torch.tensor([0.0, 1e-12, 1e-3, 50.0])
    got, want = tonemap(acc, 1.2), tonemap_reference(acc, 1.2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    d = (to_u8(Vec3(*got)).int() - to_u8(Vec3(*want)).int()).abs()
    assert d.max() <= 1 and (d == 0).double().mean() >= 0.9999


@pytest.mark.parametrize("env_mode,sampling", [("equirect", "bilinear"),
                                               ("cubemap", "nearest")])
def test_textured_route_launches_and_agrees(cuda_device, tmp_path, env_mode,
                                            sampling):
    """spp 3 with an env map: kernel A and E three times a frame, F once,
    B never; cornell strict against the plain path on the card; one
    image write launches G once."""
    cfg = RenderConfig(width=128, height=32, bounces=2, spp=3, rng="counter",
                       scene="cornell_box", env_mode=env_mode,
                       env_sampling=sampling, num_frames=2, warmup_frames=0,
                       backend="cuda")
    tex = _env_texture(env_mode, cuda_device)
    r = OfflineRenderer(cfg, texture=tex, silent=True)
    plain = OfflineRenderer(cfg.replace(backend="torch"), texture=tex,
                            device=cuda_device, silent=True)
    kernels = (render_planes, env_lookup, combine_accumulate, env_accumulate,
               tonemap)
    before = [k.launches for k in kernels]
    r.run()
    for _ in range(2):
        plain.step()
    r.write_image(str(tmp_path / "t.png"))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [6, 6, 2, 0, 1]
    torch.testing.assert_close(r.accum, plain.accum, rtol=1e-4, atol=1e-5)


def test_checkpoint_resume_bit_equal(cuda_device, tmp_path):
    cfg = RenderConfig(width=128, height=32, bounces=3, spp=2, rng="counter",
                       env_sampling="bilinear", num_frames=4, warmup_frames=1,
                       backend="cuda")
    tex = _env_texture("equirect", cuda_device)
    path = str(tmp_path / "c.npz")
    OfflineRenderer(cfg, texture=tex, silent=True).run(path, 2)
    b = OfflineRenderer(cfg.replace(num_frames=2), texture=tex, silent=True)
    b.resume(path)
    b.run()
    whole = OfflineRenderer(cfg.replace(num_frames=6), texture=tex,
                            silent=True)
    whole.run()
    assert b.frame == whole.frame == 6
    assert torch.equal(b.accum, whole.accum)


def test_new_wrappers_reject_bad_inputs(cuda_device):
    dev = cuda_device
    tex = _env_texture("equirect", dev)
    cfg = RenderConfig(width=64, height=16)
    with pytest.raises(ValueError):
        env_lookup(torch.zeros((11, 16, 64), device=dev), tex, cfg)
    with pytest.raises(ValueError):
        gather_texels(tex, torch.zeros(4, dtype=torch.int32, device=dev),
                      torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        combine_accumulate(torch.zeros((16 * 64, 3), device=dev),
                           torch.zeros((3, 16, 64), device=dev),
                           torch.zeros((3, 16, 64), device=dev),
                           torch.zeros((3, 16, 64), device=dev), 1.0)
    with pytest.raises(ValueError):   # the card takes per-sample rgb only
        combine_accumulate(torch.zeros((2, 16 * 64, 4), device=dev),
                           torch.zeros((3, 16, 64), device=dev),
                           torch.zeros((2, 3, 16, 64), device=dev),
                           torch.zeros((3, 16, 64), device=dev), 1.0)
    with pytest.raises(ValueError):
        tonemap(torch.zeros((4, 16, 64), device=dev))


# ---- the probe kernels (K6-K8) ----------------------------------------


@pytest.mark.parametrize("hw", [(64, 256), (7, 45)])
def test_trace_dots_matches_plain(cuda_device, hw):
    xn, Bn = trace_probe.probe_inputs(*hw)
    x, B = torch.from_numpy(xn).to(cuda_device), torch.from_numpy(Bn).to(cuda_device)
    want = trace_probe.trace_dots_reference(x, B)
    # the CUDA cores run the plain version's chains in its order
    torch.testing.assert_close(trace_probe.trace_dots(x, B, "cuda_core"), want,
                               rtol=1e-6, atol=0)
    # 3xTF32 on the tensor cores: near f32 (one TF32 pass gives ~1e-3);
    # the ragged 7x45 frame leaves a partial 16-pixel tile
    got = trace_probe.trace_dots(x, B, "tensor_core")
    assert trace_probe.max_rel_err(got, want) < 1e-4


@pytest.mark.parametrize("layout", ["one_plane", "three_planes", "packed"])
def test_texel_gather_bit_equal(cuda_device, layout):
    tex, rows, cols = gather_bench.bench_inputs(1)
    texf = torch.from_numpy(tex.reshape(-1, 3)).to(cuda_device)
    flat = torch.from_numpy(rows * gather_bench.W + cols).to(cuda_device)
    flat[:3] = torch.tensor([-5, 0, 10 ** 7])          # clamped at both ends
    planes = texf.t().contiguous()
    table = {"one_plane": planes[:1], "three_planes": planes,
             "packed": torch.cat([texf, texf[:, :1]], 1).contiguous()}[layout]
    packed = layout == "packed"
    got = gather_bench.texel_gather(table, flat, packed)
    assert torch.equal(got, gather_bench.texel_gather_reference(table, flat, packed))


@pytest.mark.parametrize("n", [5, 1024, 4099])
@pytest.mark.parametrize("row", [128, 4])
@pytest.mark.parametrize("mechanism", ["tma", "cp_async"])
def test_row_copy_bit_equal(cuda_device, mechanism, row, n):
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.random((4096, row), dtype=np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-2, 4100, n, dtype=np.int32)).to(cuda_device)
    got = overlap_probe.row_copy(table, idx, mechanism)
    assert torch.equal(got, overlap_probe.row_copy_reference(table, idx))


@pytest.mark.parametrize("n", [2048, 921600, 3])
def test_dsmem_gather_bit_equal(cuda_device, n):
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.random((256, 512), dtype=np.float32)).to(cuda_device)
    rows = torch.from_numpy(rng.integers(-1, 257, n, dtype=np.int32)).to(cuda_device)
    cols = torch.from_numpy(rng.integers(-1, 513, n, dtype=np.int32)).to(cuda_device)
    got = overlap_probe.dsmem_gather(table, rows, cols)
    assert torch.equal(got, overlap_probe.dsmem_gather_reference(table, rows, cols))


def test_probe_entry_points_count_launches(cuda_device):
    kernels = (trace_probe.trace_dots, gather_bench.texel_gather,
               overlap_probe.row_copy, overlap_probe.dsmem_gather)
    for k in kernels:
        k.launches = 0
    t = trace_probe.run(cuda_device, 16, 256, iters=2)
    g = gather_bench.run(cuda_device, iters=2)
    o = overlap_probe.run(cuda_device, "all", width=128, height=64)
    assert all(k.launches > 0 for k in kernels)
    assert t["max_rel_err"] < 1e-4
    assert all(g["correct"].values())
    assert all(o["p2"]["correct"].values()) and all(o["p3"]["correct"].values())


def test_probe_wrappers_reject_bad_inputs(cuda_device):
    dev = cuda_device
    x = torch.zeros((8, 4, 16), device=dev)
    with pytest.raises(ValueError):
        trace_probe.trace_dots(x, torch.zeros((54, 8), device=dev), "mxu")
    with pytest.raises(ValueError):
        trace_probe.trace_dots(x[:7], torch.zeros((54, 8), device=dev))
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        gather_bench.texel_gather(torch.zeros((10, 3), device=dev), idx, packed=True)
    with pytest.raises(ValueError):
        gather_bench.texel_gather(torch.zeros((1, 10), device=dev), idx.long())
    with pytest.raises(ValueError):
        overlap_probe.row_copy(torch.zeros((10, 6), device=dev), idx)
    with pytest.raises(ValueError):
        overlap_probe.row_copy(torch.zeros((10, 132), device=dev), idx)
    with pytest.raises(ValueError):
        overlap_probe.dsmem_gather(torch.zeros((128, 512), device=dev), idx, idx)


# ---- fixed-order sums (kernels C and D), the diff path's cubemap, G --------


def _beer_or_cornell(case, h, w, dev):
    if case == "beer":
        scene, cam = port_beer_scene(dev)
        cfg = RenderConfig(width=w, height=h, bounces=4, rng="counter",
                           roulette="v4_quirk")
    else:
        scene, cam = scene_by_name("cornell_box", device=dev)
        cfg = RenderConfig(width=w, height=h, bounces=2, rng="counter",
                           scene="cornell_box", env_mode="none",
                           roulette="terminate")
    return pack_tables(scene, cam, cfg, dev), cfg


@pytest.mark.parametrize("hw", [(64, 256), (7, 45), (3, 5)])
@pytest.mark.parametrize("case", ["beer", "cornell"])
def test_bwd_tables_bit_equal_twice_and_matches_plain(cuda_device, case, hw):
    """Kernel C sums in a fixed order: two launches give the same bits; both
    match the plain version under phase 6's tolerances, also at sizes that
    are no multiple of 32 and below one chunk a warp."""
    tables, cfg = _beer_or_cornell(case, *hw, cuda_device)
    cot6 = _cot6(cfg, cuda_device, seed=3)
    first = bwd_tables(tables, cfg, 2, 0, cot6)
    second = bwd_tables(tables, cfg, 2, 0, cot6)
    want = bwd_tables_reference(tables, cfg, 2, 0, cot6)
    torch.cuda.synchronize()
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0.0
    for a, b, w in zip(first, second, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        torch.testing.assert_close(a, w, rtol=1e-3, atol=1e-3 * scale)


def test_bwd_tables_counts_lanes_and_clocks(cuda_device):
    """lane_stats counts a utilisation in (0, 1]; the instrumented instance
    gives the same cotangents and cycles in every part, the parts summing
    to the whole."""
    tables, cfg = _beer_or_cornell("beer", 32, 128, cuda_device)
    cot6 = _cot6(cfg, cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    clocks = torch.zeros(6, dtype=torch.int64, device=cuda_device)
    plain = bwd_tables(tables, cfg, 1, 0, cot6, lane_stats=stats)
    timed = bwd_tables(tables, cfg, 1, 0, cot6, clocks=clocks)
    torch.cuda.synchronize()
    live, slots = stats.tolist()
    assert 0 < live <= slots and slots % 32 == 0
    parts = clocks.tolist()
    assert min(parts) > 0 and sum(parts[:5]) == parts[5]
    for a, b in zip(plain, timed):
        assert torch.equal(a, b)


def test_bwd_tables_raises_when_the_stacks_do_not_fit(cuda_device):
    tables, cfg = _beer_or_cornell("beer", 8, 32, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        bwd_tables(tables, cfg.replace(bounces=200), 1, 0,
                   _cot6(cfg, cuda_device))


@pytest.mark.parametrize("case", ["one_texel", "alternating", "random", "runs",
                                  "zero_mt", "signed_zeros_nan", "ragged"])
def test_env_backward_fixed_order(cuda_device, case):
    """Kernel D twice: the same bits, equal to the plain-torch model of its
    order (run records, stable sort, segmented sum) on the CPU."""
    g, idx, mt, tex = _kernel_d_inputs(case, cuda_device)
    _, first = env_backward(g, idx, mt, tex)
    _, second = env_backward(g, idx, mt, tex)
    model = kernel_d_order(g, idx, mt, tex.width * tex.height)
    torch.cuda.synchronize()
    for a, b, m in zip(first, second, model):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        a = a.cpu()
        assert torch.equal(a.isnan(), m.isnan())  # NaN payloads may differ
        assert torch.equal(a[~a.isnan()].view(torch.int32),
                           m[~m.isnan()].view(torch.int32))


def _glass_step(dev, env_mode="equirect", sampling="stochastic"):
    if env_mode == "cubemap":
        tex = _env_texture("cubemap", dev)
    else:
        tex = texture_from_array(gradient_sky(64, 32), dev)
    scene, cam = scene_by_name("glass_spheres", device=dev)
    cfg = RenderConfig(width=256, height=64, bounces=3, rng="counter",
                       env_mode=env_mode, env_sampling=sampling)
    params = default_bench_params(scene, tex)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    return params, target, scene, cam, tex, cfg


def test_training_step_bit_equal_twice(cuda_device):
    """Two training steps on the same frame: the same loss and gradients,
    bit for bit (kernels A-D and the torch ops around them)."""
    params, target, scene, cam, tex, cfg = _glass_step(cuda_device)
    la, ga = loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    lb, gb = loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    assert torch.equal(la, lb)
    for k in params:
        assert torch.equal(ga[k].view(torch.int32), gb[k].view(torch.int32)), k


@pytest.mark.parametrize("sampling", ["stochastic", "nearest"])
def test_env_accumulate_cubemap_index_matches_plain(cuda_device, sampling):
    """Kernel B's cubemap tap (the unflipped direction) vs the plain route."""
    cfg = RenderConfig(width=256, height=64, bounces=2, rng="counter",
                       env_mode="cubemap", env_sampling=sampling)
    tables = _tables("glass_spheres", cfg, cuda_device)
    tex = _env_texture("cubemap", cuda_device)
    planes = render_planes(tables, cfg, 1)
    got, want = (torch.zeros((3, 64, 256), device=cuda_device) for _ in range(2))
    gi = torch.empty((64, 256), dtype=torch.int64, device=cuda_device)
    wi = torch.empty_like(gi)
    env_accumulate(planes, tex, cfg, got, 1.0, index_out=gi)
    env_accumulate_reference(planes, tex, cfg, want, 1.0, index_out=wi)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sampling", ["stochastic", "nearest"])
def test_render_frame_diff_cubemap_matches_plain(cuda_device, sampling):
    params, target, scene, cam, tex, cfg = _glass_step(cuda_device, "cubemap",
                                                       sampling)
    lc, gc = loss_and_grad(params, target, scene, cam, tex, cfg, 1)
    lt, gt = loss_and_grad(params, target, scene, cam, tex,
                           cfg.replace(backend="torch"), 1)
    assert abs(lc.item() - lt.item()) <= 1e-3 * abs(lt.item())
    for k in params:
        assert torch.isfinite(gc[k]).all(), k
        na, nb = gt[k].norm().item(), gc[k].norm().item()
        assert na > 0 and abs(na - nb) <= 0.05 * na, (k, na, nb)


@pytest.mark.parametrize("shape,offset", [((3, 5, 7), 0), ((3, 37, 53), 1),
                                          ((3, 1080, 1920), 0), ((3, 2, 2), 0)])
def test_tonemap_vectorised_tail_and_alignment(cuda_device, shape, offset):
    """Kernel G's 16-byte path, its tail of 3*H*W mod 4 values and an input
    that is not 16-byte aligned: u8 equal to the plain version on >= 99.99%
    of values and never off by more than 1."""
    from cpuperformanceraytracer_tpu_torch.core.color import to_u8
    from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    n = shape[0] * shape[1] * shape[2]
    flat = torch.rand(n + offset, device=cuda_device, generator=gen) * 4
    acc = flat[offset:].view(shape)
    got, want = tonemap(acc, 0.9), tonemap_reference(acc, 0.9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    d = (to_u8(Vec3(*got)).int() - to_u8(Vec3(*want)).int()).abs()
    assert d.max() <= 1 and (d == 0).double().mean() >= 0.9999


def test_kernels_c_and_d_capture_in_a_cuda_graph(cuda_device):
    """Kernels C and D (with its library sort) enqueue no host
    synchronisation: a CUDA graph captures them, and a replay gives the
    launches' bits."""
    tables, cfg = _beer_or_cornell("beer", 32, 128, cuda_device)
    cot6 = _cot6(cfg, cuda_device)
    g, idx, mt, tex = _kernel_d_inputs("runs", cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (builds, caches) off the graph
        bwd_tables(tables, cfg, 1, 0, cot6)
        env_backward(g, idx, mt, tex)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d_tables = bwd_tables(tables, cfg, 1, 0, cot6)
        _, d_tex = env_backward(g, idx, mt, tex)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(d_tables, bwd_tables(tables, cfg, 1, 0, cot6)):
        assert torch.equal(a, b)
    for a, b in zip(d_tex, env_backward(g, idx, mt, tex)[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
def test_grad_step_k_graph_bit_equal_to_ungraphed(cuda_device, backend):
    """K steps in one CUDA graph: grad_sum and losses equal K ungraphed
    steps summed in the same order, bit for bit, and a second replay reads
    the new frame0 from the device (the frame is not frozen)."""
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
        grad_steps,
        bench_loss,
        make_grad_step_k,
    )

    params, _, scene, cam, tex, cfg = _glass_step(cuda_device)
    cfg = cfg.replace(backend=backend, remat_bounces=backend == "oracle")
    loss_fn = bench_loss(cfg, scene, cam, tex)
    step_k = make_grad_step_k(loss_fn, 3)
    for frame0 in (5, 8):
        got_sum, got_losses = step_k(params, frame0)
        want_sum, want_losses = grad_steps(loss_fn, params,
                                         [frame0 + i for i in range(3)])
        torch.cuda.synchronize()
        assert _bits_equal(got_losses, want_losses), (got_losses, want_losses)
        for k in params:
            assert _bits_equal(got_sum[k], want_sum[k]), k
    assert len(set(got_losses.tolist())) == 3


def test_wrappers_count_launches_not_captures(cuda_device):
    """A wrapper counts the kernels it launches: the warm-up run before a
    K-step graph's capture counts, the capture and the replays do not
    (torch.profiler counts the replays' launches on the device)."""
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
        bench_loss,
        make_grad_step_k,
    )

    params, _, scene, cam, tex, cfg = _glass_step(cuda_device)
    loss_fn = bench_loss(cfg, scene, cam, tex)
    kernels = (render_planes, env_accumulate, bwd_tables, env_backward)
    before = [k.launches for k in kernels]
    step_k = make_grad_step_k(loss_fn, 3)
    for frame0 in (0, 3):
        step_k(params, frame0)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [3, 3, 3, 3]


def test_train_step_k_graph_bit_equal_to_ungraphed(cuda_device):
    """K graphed Adam steps (capturable) leave the parameters and losses
    bit-equal to K ungraphed capturable steps, over two replays; the tail
    of adam_inverse_render takes a graph of its own."""
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        adam_inverse_render,
        make_train_step,
        make_train_step_k,
    )

    params, target, scene, cam, tex, cfg = _glass_step(cuda_device)
    problem = InverseProblem(scene, cam, tex, cfg, target)

    def fresh():
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        return p, torch.optim.Adam(list(p.values()), lr=0.01, capturable=True)

    pg, opt_g = fresh()
    pu, opt_u = fresh()
    graphed = make_train_step_k(problem, opt_g, 3, resample_frames=True)
    plain = make_train_step(problem, opt_u, resample_frames=True)
    for step0 in (0, 3):
        got = graphed(pg, step0)
        want = torch.stack([plain(pu, step0 + i) for i in range(3)])
        torch.cuda.synchronize()
        assert _bits_equal(got, want), (got, want)
        for k in params:
            assert _bits_equal(pg[k].detach(), pu[k].detach()), k
    init = {"albedo": params["albedo"]}
    a, la = adam_inverse_render(problem, init, steps=5, steps_per_dispatch=2,
                                resample_frames=True)
    b, lb = adam_inverse_render(problem, init, steps=5, steps_per_dispatch=1,
                                resample_frames=True)
    assert la == lb and _bits_equal(a["albedo"], b["albedo"])


def test_oracle_on_the_card_matches_the_cpu(cuda_device):
    """The oracle integrator on the card: the diffuse cornell box with an
    env map at spp 2 and the wang RNG (the config the kernel routes
    refuse) as on the CPU, rtol 1e-4 and atol 1e-5 (torch's CPU sqrt is an
    ulp off on some inputs)."""
    from cpuperformanceraytracer_tpu_torch.render.integrator import render_frame

    cfg = RenderConfig(width=128, height=32, bounces=2, spp=2, rng="wang",
                       scene="cornell_box", backend="oracle")
    got = render_frame(*scene_by_name("cornell_box", device=cuda_device),
                       texture_from_array(gradient_sky(64, 32), cuda_device),
                       cfg, 3)
    want = render_frame(*scene_by_name("cornell_box"),
                        texture_from_array(gradient_sky(64, 32)), cfg, 3)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rng", ["wang", "counter"])
@pytest.mark.parametrize("h,w,row0,rows", [(32, 128, 16, 16), (7, 45, 2, 4),
                                           (24, 64, 0, 8), (24, 64, 23, 1)])
def test_megakernel_window_bit_equal_to_rows(cuda_device, rng, h, w, row0,
                                             rows):
    """Kernel A on a row window: bit-equal to those rows of the whole
    launch and to the plain version's window (global rows key the RNG and
    cast the rays)."""
    cfg = RenderConfig(width=w, height=h, bounces=3, spp=2,
                       scene="cornell_box", env_mode="none", rng=rng)
    tables = _tables("cornell_box", cfg, cuda_device)
    full = render_planes(tables, cfg, 4, sample0=1)
    got = render_planes(tables, cfg, 4, sample0=1, row0=row0,
                        local_height=rows)
    want = render_planes_reference(tables, cfg, 4, sample0=1, row0=row0,
                                   local_height=rows)
    torch.cuda.synchronize()
    assert got.shape == (12, rows, w)
    assert torch.equal(got, full[:, row0:row0 + rows])
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["beer", "cornell"])
def test_bwd_tables_window_bit_equal_twice_and_matches_plain(cuda_device,
                                                              case):
    """Kernel C on a row window: two launches give the same bits; both
    match the plain version's window and the whole image's cotangents
    with the other rows zeroed, under phase 6's tolerances."""
    tables, cfg = _beer_or_cornell(case, 64, 256, cuda_device)
    cot6 = _cot6(cfg, cuda_device, seed=5)[:, 20:52].contiguous()
    first = bwd_tables(tables, cfg, 2, 0, cot6, row0=20, local_height=32)
    second = bwd_tables(tables, cfg, 2, 0, cot6, row0=20, local_height=32)
    want = bwd_tables_reference(tables, cfg, 2, 0, cot6, row0=20,
                                local_height=32)
    whole = torch.zeros((6, 64, 256), device=cuda_device)
    whole[:, 20:52] = cot6
    padded = bwd_tables(tables, cfg, 2, 0, whole)
    torch.cuda.synchronize()
    scale = max(w.abs().max().item() for w in want)
    assert scale > 0.0
    for a, b, w, p in zip(first, second, want, padded):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        torch.testing.assert_close(a, w, rtol=1e-3, atol=1e-3 * scale)
        torch.testing.assert_close(a, p, rtol=1e-4, atol=1e-5 * scale)


def _two_ranks_on_one_card(cfg, params, target):
    """A rank of a gloo world of 2 sharing the card: the px-sharded frame
    and training step (CPU copies of its results)."""
    from cpuperformanceraytracer_tpu_torch.parallel import shard
    from cpuperformanceraytracer_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda")
    mesh = make_mesh((2, 1))
    scene, cam = scene_by_name(cfg.scene, device=dev)
    tex = texture_from_array(gradient_sky(64, 32), dev)
    frame = shard.sharded_render_frame(scene, cam, tex, cfg, 3, mesh)
    loss, grads = shard.sharded_loss_and_grad(
        {k: v.to(dev) for k, v in params.items()}, target.to(dev), scene,
        cam, tex, cfg, 3, mesh)
    return frame.cpu(), loss.cpu(), {k: g.cpu() for k, g in grads.items()}


def test_sharded_frame_and_step_on_two_ranks_of_one_card(cuda_device):
    """Two gloo ranks on the one card (px = 2): the frame bit-equal to the
    unsharded kernel route, the step's loss within 1e-5 relative and its
    gradients within 1e-5 relative L2 of the unsharded step's."""
    from cpuperformanceraytracer_tpu_torch.kernels._build import load_library
    from cpuperformanceraytracer_tpu_torch.parallel.mesh import spawn_world
    from cpuperformanceraytracer_tpu_torch.render.frame import make_frame_fn

    load_library()  # built once, before the ranks start
    cfg = RenderConfig(width=128, height=32, bounces=3, rng="counter",
                       scene="glass_spheres")
    scene, cam = scene_by_name(cfg.scene, device=cuda_device)
    tex = texture_from_array(gradient_sky(64, 32), cuda_device)
    want = make_frame_fn(cfg, scene, cam, cuda_device)(
        tex, 3, torch.zeros((3, 32, 128), device=cuda_device), 1.0)
    params = {k: v.cpu() for k, v in
              default_bench_params(scene, tex).items()}
    target = render_for_params({}, scene, cam, tex, cfg, 0).detach().cpu()
    loss, grads = loss_and_grad({k: v.to(cuda_device) for k, v in params.items()},
                                target.to(cuda_device), scene, cam, tex, cfg, 3)
    for frame, l, g in spawn_world(_two_ranks_on_one_card, 2,
                                   (cfg, params, target), timeout=300):
        assert torch.equal(frame, want.cpu())
        assert abs(l.item() - loss.item()) <= 1e-5 * abs(loss.item())
        for k, v in grads.items():
            v = v.cpu().double()
            assert ((g[k].double() - v).norm() / v.norm()).item() < 1e-5, k
