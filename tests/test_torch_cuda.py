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
    NOTHING_TRACED,
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


@pytest.mark.parametrize("hw", [(64, 256), (7, 45), (720, 1280)])
def test_trace_dots_wgmma_matches_plain_and_cuda_core(cuda_device, hw):
    """The wgmma unit (3xTF32, a warpgroup a 64-pixel tile) within the
    tensor_core unit's 1e-4 of the plain version and of the CUDA cores;
    7x45 leaves a ragged last tile; two launches, the same bits."""
    xn, Bn = trace_probe.probe_inputs(*hw)
    x, B = torch.from_numpy(xn).to(cuda_device), torch.from_numpy(Bn).to(cuda_device)
    want = trace_probe.trace_dots_reference(x, B)
    got = trace_probe.trace_dots(x, B, "wgmma")
    assert trace_probe.max_rel_err(got, want) < 1e-4
    assert trace_probe.max_rel_err(got, trace_probe.trace_dots(x, B, "cuda_core")) < 1e-4
    again = trace_probe.trace_dots(x, B, "wgmma")
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("n", [0, 1, 3, 5, 2048, 921600])
@pytest.mark.parametrize("layout", ["one_plane", "three_planes", "packed"])
def test_texel_gather_counts_and_views(cuda_device, layout, n):
    """Each layout bit-equal at awkward counts and on index views 4, 8 and
    12 bytes off (a scalar head); two launches give the same bits."""
    tex, rows, cols = gather_bench.bench_inputs(3)
    texf = torch.from_numpy(tex.reshape(-1, 3)).to(cuda_device)
    planes = texf.t().contiguous()
    table = {"one_plane": planes[:1], "three_planes": planes,
             "packed": torch.cat([texf, texf[:, :1]], 1).contiguous()}[layout]
    packed = layout == "packed"
    flat = torch.from_numpy(rows * gather_bench.W + cols).to(cuda_device)
    flat[:2] = torch.tensor([-7, 10 ** 8])
    for k in range(4):
        idx = flat[k:k + n]
        got = gather_bench.texel_gather(table, idx, packed)
        assert torch.equal(got, gather_bench.texel_gather_reference(table, idx, packed)), k
        assert got.is_contiguous()
    again = gather_bench.texel_gather(table, idx, packed)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("n", [5, 256, 1024, 4096, 4099, 9000])
@pytest.mark.parametrize("row", [128, 4])
@pytest.mark.parametrize("mechanism", ["tma", "cp_async"])
def test_row_copy_bit_equal(cuda_device, mechanism, row, n):
    """Every depth; 9000 copies cross two edges of the staged chunks."""
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.random((4096, row), dtype=np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-2, 4100, n, dtype=np.int32)).to(cuda_device)
    want = overlap_probe.row_copy_reference(table, idx)
    for depth in range(1, 9):
        got = overlap_probe.row_copy(table, idx, mechanism, depth)
        assert torch.equal(got, want), depth


@pytest.mark.parametrize("n", [0, 1, 3, 5, 2048, 921600])
def test_dsmem_gather_bit_equal(cuda_device, n):
    """Views of rows and cols that start 4, 8 and 12 bytes off, together
    (a scalar head) and apart (all scalar)."""
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.random((256, 512), dtype=np.float32)).to(cuda_device)
    rows = torch.from_numpy(rng.integers(-1, 257, n + 3, dtype=np.int32)).to(cuda_device)
    cols = torch.from_numpy(rng.integers(-1, 513, n + 3, dtype=np.int32)).to(cuda_device)
    views = [(rows[:n], cols[:n])] + [(rows[k:k + n], cols[k:k + n]) for k in (1, 2, 3)]
    views.append((rows[1:n + 1], cols[:n]))
    for r, c in views:
        got = overlap_probe.dsmem_gather(table, r, c)
        assert torch.equal(got, overlap_probe.dsmem_gather_reference(table, r, c))


def test_dsmem_gather_repeats_bits(cuda_device):
    tex, rows, cols = gather_bench.bench_inputs(2)
    table = torch.from_numpy(tex[:, :, 0].copy()).to(cuda_device)
    r, c = (torch.from_numpy(a).to(cuda_device) for a in (rows, cols))
    first = overlap_probe.dsmem_gather(table, r, c)
    assert torch.equal(overlap_probe.dsmem_gather(table, r, c), first)


def test_probe_entry_points_count_launches(cuda_device):
    kernels = (trace_probe.trace_dots, gather_bench.texel_gather,
               overlap_probe.row_copy, overlap_probe.dsmem_gather)
    for k in kernels:
        k.launches = 0
    t = trace_probe.run(cuda_device, 16, 256, iters=2)
    g = gather_bench.run(cuda_device, iters=2)
    o = overlap_probe.run(cuda_device, "all", width=128, height=64)
    assert all(k.launches > 0 for k in kernels)
    assert t["max_rel_err"] < 1e-4 and t["max_rel_err_wgmma"] < 1e-4
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
    with pytest.raises(ValueError):
        overlap_probe.row_copy(torch.zeros((10, 4), device=dev), idx, "tma", 9)


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


def test_bwd_tables_counts_lanes(cuda_device):
    """lane_stats counts a utilisation in (0, 1], and counting leaves the
    cotangents as they are."""
    tables, cfg = _beer_or_cornell("beer", 32, 128, cuda_device)
    cot6 = _cot6(cfg, cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    counted = bwd_tables(tables, cfg, 1, 0, cot6, lane_stats=stats)
    plain = bwd_tables(tables, cfg, 1, 0, cot6)
    torch.cuda.synchronize()
    live, slots = stats.tolist()
    assert 0 < live <= slots and slots % 32 == 0
    for a, b in zip(counted, plain):
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


def test_run_offline_resume_bit_equal_on_the_card(cuda_device, tmp_path):
    """Config 5's driver at 256x128, 8 frames, a checkpoint every 2: the
    resumed accumulator bit-equal to one uninterrupted run."""
    from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu_torch.scripts.run_offline_4k import (
        run_offline,
    )

    cfg = BENCH_CONFIGS["offline_4k"].replace(width=256, height=128,
                                              num_frames=8)
    tex = texture_from_array(gradient_sky(512, 256))
    summary, state = run_offline(cfg, tex, str(tmp_path / "o.png"),
                                 checkpoint_every=2)
    assert summary["resumed_at_frame"] == 4 and state.frame == 8
    whole = OfflineRenderer(cfg, texture=tex, silent=True)
    whole.run()
    torch.cuda.synchronize()
    assert torch.equal(state.accum, whole.accum)
    assert torch.isfinite(state.accum).all() and state.accum.mean() > 0


def test_inverse_env_graphed_chunk(cuda_device):
    """Config 4's driver at 64x32 with a 32x16 env: one graphed chunk of
    16 Adam steps over the albedos and every texel; finite parameters and
    a falling loss."""
    from cpuperformanceraytracer_tpu_torch.scripts.inverse_env_demo import (
        DEMO,
        inverse_env,
    )

    r = inverse_env(DEMO.replace(width=64, height=32),
                    texture_from_array(gradient_sky(32, 16)), steps=16,
                    warm_chunks=1, timed_chunks=1)
    assert r["params_finite"] and r["loss_last"] < r["loss_first"]
    assert r["params"]["env_rgb"].shape == (32 * 16, 3)
    assert r["device"] == torch.cuda.get_device_name(cuda_device)


# ---- tracing (utils/profiling) on the card ----------------------------------

PHASES = {"step.render", "step.loss", "step.backward", "step.adam"}


@pytest.fixture
def tracing():
    """``utils/profiling``, off and reset before and after the test."""
    from cpuperformanceraytracer_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _train_graph(dev, k: int = 2):
    """(step_k, params): K graphed Adam steps over ``_glass_step``'s
    parameters, a fresh sample a step."""
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        make_train_step_k,
    )

    params, target, scene, cam, tex, cfg = _glass_step(dev)
    p = {n: v.detach().clone().requires_grad_() for n, v in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=0.01, capturable=True)
    step_k = make_train_step_k(InverseProblem(scene, cam, tex, cfg, target),
                               opt, k, resample_frames=True)
    return step_k, p


def _lanes_ok(lanes: dict, kernels: set) -> bool:
    return set(lanes) == kernels and all(
        0 < live <= slots for live, slots in lanes.values())


def test_tracing_counts_the_lanes_of_kernels_a_and_c(cuda_device, tracing):
    """With tracing on, frames count kernel A's lanes and a training step
    A's and C's, 0 < live <= slots; with tracing off nothing counts."""
    cfg = RenderConfig(width=128, height=32, bounces=2, env_mode="none",
                       warmup_frames=0, num_frames=2)
    r = OfflineRenderer(cfg, silent=True)
    r.step()
    params, target, scene, cam, tex, tcfg = _glass_step(cuda_device)
    loss_and_grad(params, target, scene, cam, tex, tcfg, 1)
    assert tracing.read() == NOTHING_TRACED
    tracing.enable()
    r.step()
    assert _lanes_ok(tracing.read()["lanes"], {"kernel_a"})
    tracing.reset()
    loss_and_grad(params, target, scene, cam, tex, tcfg, 1)
    assert _lanes_ok(tracing.read()["lanes"], {"kernel_a", "kernel_c"})


def test_a_graph_captured_with_tracing_on_times_its_phases(cuda_device,
                                                          tracing):
    """A K = 2 graph captured with tracing on: its replays time four
    positive phases a step, which end to end make up the replay's device
    time, and count A's and C's lanes, even with tracing off by then (the
    flag is read at capture)."""
    tracing.enable()
    step_k, p = _train_graph(cuda_device)
    step_k(p, 0)
    tracing.disable()
    tracing.reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e7))     # the replay is enqueued before it starts
    start.record()
    step_k(p, 2)
    end.record()
    got = tracing.read()
    phases = got["phases_ms"]
    assert set(phases) == PHASES and min(phases.values()) > 0, phases
    per_step = start.elapsed_time(end) / 2
    # the replay's device time holds the phases and the frame's fill_
    assert 0.8 * per_step <= sum(phases.values()) <= per_step, (phases,
                                                                per_step)
    assert _lanes_ok(got["lanes"], {"kernel_a", "kernel_c"})


def test_a_graph_captured_with_tracing_off_records_nothing(cuda_device,
                                                         tracing):
    step_k, p = _train_graph(cuda_device)
    step_k(p, 0)
    tracing.enable()
    tracing.reset()
    for step0 in (2, 4):
        step_k(p, step0)
    assert tracing.read() == NOTHING_TRACED


def test_reset_zeroes_the_counters_and_keeps_the_graph(cuda_device, tracing):
    tracing.enable()
    step_k, p = _train_graph(cuda_device)
    step_k(p, 0)
    tracing.reset()
    assert tracing.read() == NOTHING_TRACED
    losses = step_k(p, 2)
    got = tracing.read()
    assert torch.isfinite(losses).all()
    assert _lanes_ok(got["lanes"], {"kernel_a", "kernel_c"})
    assert set(got["phases_ms"]) == PHASES


def test_replays_count_the_launches_their_capture_made(cuda_device):
    """N replays of a K = 2 graph count N x 2 launches of each of A-D in
    ``profiling.replayed_launches()``, as many as torch.profiler counts on
    the device, and leave the wrappers' own counts as they were. The
    profiler now and then drops records of a replay: a trace short of
    the count is taken again, up to 3 times."""
    from cpuperformanceraytracer_tpu_torch.utils import profiling

    step_k, p = _train_graph(cuda_device)
    step_k(p, 0)
    kernels = (render_planes, env_accumulate, bwd_tables, env_backward)
    names = {"render_planes": "render_planes_kernel",
             "env_accumulate": "env_accumulate_kernel",
             "bwd_tables": "bwd_tables_kernel",
             "env_backward": "env_runs_kernel"}
    want = dict.fromkeys(names, 3 * 2)
    for _ in range(3):
        before = [k.launches for k in kernels]
        counted = profiling.replayed_launches()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for step0 in (2, 4, 6):
                step_k(p, step0)
            torch.cuda.synchronize()
        after = profiling.replayed_launches()
        replayed = {n: after.get(n, 0) - counted.get(n, 0) for n in names}
        device = {n: sum(e.count for e in prof.key_averages() if fn in e.key)
                  for n, fn in names.items()}
        assert replayed == want
        assert [k.launches for k in kernels] == before
        if device == want or any(device[n] > want[n] for n in names):
            break
    assert device == want


# ---- Adam's kernel (kernels/adam.py) ----------------------------------------

# the 720p main path's leaves: albedo, sphere centers, every env texel
ADAM_720P = ((11, 3), (7, 3), (131072, 3))
ADAM_OPTIONS = {"default": {}, "eps_1e-2": {"eps": 1e-2},
                "decay_maximize": {"weight_decay": 0.1, "maximize": True},
                "beta1_0.3": {"betas": (0.3, 0.9)}}


def _adam_pair(dev, layout: str, options: dict, seed: int = 0,
               lr: float = 0.01):
    """Two copies of the same leaves, each under its own
    ``torch.optim.Adam(lr=lr, capturable=True)``. ``main_720p``: the main path's
    leaf shapes. ``odd_unaligned``: a leaf of 1001 values starting 4 bytes
    into its buffer, its state made by the optimizer (16-byte aligned), so
    its arrays are aligned apart. ``odd_shared_offset``: a leaf of 4099
    values whose param, gradient and state all start 12 bytes into their
    buffers (a head, 16-byte vectors and a tail)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"main_720p": ADAM_720P, "odd_unaligned": ((1001,), (7, 3)),
              "odd_shared_offset": ((4099,), (11, 3))}[layout]
    first = [(0.5 + torch.rand(s, device=dev, generator=gen))
             * torch.where(torch.rand(s, device=dev, generator=gen) < 0.5,
                           -1.0, 1.0) for s in shapes]
    offset = {"odd_unaligned": 1, "odd_shared_offset": 3}.get(layout, 0)

    def at_offset(t):
        buf = torch.empty(t.numel() + offset, device=dev)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out

    copies = []
    for _ in range(2):
        leaves = [at_offset(t).requires_grad_() if i == 0 else
                  t.clone().requires_grad_() for i, t in enumerate(first)]
        opt = torch.optim.Adam(leaves, lr=lr, capturable=True, **options)
        if layout == "odd_shared_offset":
            opt.state[leaves[0]].update(
                step=torch.zeros((), device=dev),
                exp_avg=at_offset(torch.zeros_like(first[0])),
                exp_avg_sq=at_offset(torch.zeros_like(first[0])))
        copies.append((leaves, opt))
    grad_at = at_offset if layout == "odd_shared_offset" else (lambda t: t)

    def grads(k: int):
        g = torch.Generator(device=dev).manual_seed(1000 + k)
        return [grad_at(torch.randn(s, device=dev, generator=g) * 10.0 ** -(k % 4))
                if i == 0 else torch.randn(s, device=dev, generator=g)
                * 10.0 ** -(k % 4) for i, s in enumerate(shapes)]

    return copies, grads


def _adam_state_bits(leaves, opt):
    return [t.detach().clone() for p in leaves
            for t in (p, *(opt.state[p][k]
                           for k in ("step", "exp_avg", "exp_avg_sq")))]


@pytest.mark.parametrize("lr", [0.001, 0.01, 0.02, 0.05])
@pytest.mark.parametrize("option", list(ADAM_OPTIONS))
@pytest.mark.parametrize("layout", ["main_720p", "odd_unaligned",
                                    "odd_shared_offset"])
def test_adam_kernel_bit_equal_to_torch_capturable(cuda_device, layout,
                                                   option, lr):
    """16 steps of the kernel (``adam_step``) and of
    ``torch.optim.Adam(capturable=True)`` on the same leaves and gradients:
    the params, ``step``, ``exp_avg`` and ``exp_avg_sq`` bit-equal after
    every step (the arrays' alignments: see ``_adam_pair``), at the
    learning rates of the port's callers (0.01 the default, 0.02 the env
    demo's) and on either side of them: the kernel multiplies by
    ``1 / lr`` taken in double, as torch's foreach division does."""
    from cpuperformanceraytracer_tpu_torch.kernels.adam import adam, adam_step

    copies, grads = _adam_pair(cuda_device, layout, ADAM_OPTIONS[option],
                               lr=lr)
    (got, opt_got), (want, opt_want) = copies
    before = adam.launches
    for k in range(16):
        for a, b, g in zip(got, want, grads(k)):
            a.grad, b.grad = g, g.clone()   # the kernel's keeps its layout
        adam_step(opt_got)
        opt_want.step()
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(_adam_state_bits(got, opt_got),
                                       _adam_state_bits(want, opt_want))):
            assert _bits_equal(x, y), (k, i, (x != y).sum().item())
    assert adam.launches - before == 16


@pytest.mark.parametrize("option", list(ADAM_OPTIONS))
@pytest.mark.parametrize("layout", ["main_720p", "odd_shared_offset"])
def test_adam_kernel_matches_its_plain_version(cuda_device, layout, option):
    """16 steps of the kernel and of its plain version
    (``adam_reference``, torch ops) on the card, from the same leaves and
    gradients: the tolerances of the plain version's CPU test
    (``tests/test_torch_adam.py``), params rtol 1e-6, the moments rtol
    1e-6 with an atol of 1e-6 of their largest value. The plain version
    rounds ``(1 - beta2) * g * g`` before adding it, where the kernel
    fuses the multiply-add as torch does, so the last bits may differ."""
    from cpuperformanceraytracer_tpu_torch.kernels.adam import (
        adam_reference,
        adam_step,
    )

    options = ADAM_OPTIONS[option]
    copies, grads = _adam_pair(cuda_device, layout, options)
    (got, opt_got), (want, opt_want) = copies
    beta1, beta2 = options.get("betas", (0.9, 0.999))
    hyper = dict(lr=0.01, beta1=beta1, beta2=beta2,
                 eps=options.get("eps", 1e-8),
                 weight_decay=options.get("weight_decay", 0.0),
                 maximize=options.get("maximize", False))
    with torch.no_grad():
        for p in want:
            state = opt_want.state[p]
            state.setdefault("step", torch.zeros((), device=cuda_device))
            state.setdefault("exp_avg", torch.zeros_like(p))
            state.setdefault("exp_avg_sq", torch.zeros_like(p))
        for k in range(16):
            for a, b, g in zip(got, want, grads(k)):
                a.grad = g
            adam_step(opt_got)
            states = [opt_want.state[p] for p in want]
            adam_reference([p.detach() for p in want], grads(k),
                           [s["exp_avg"] for s in states],
                           [s["exp_avg_sq"] for s in states],
                           [s["step"] for s in states], **hyper)
    for a, b in zip(got, want):
        sa, sb = opt_got.state[a], opt_want.state[b]
        assert sa["step"].item() == sb["step"].item() == 16
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6, atol=0)
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sa[k], sb[k], rtol=1e-6,
                                       atol=1e-6 * sb[k].abs().max().item())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_train_step_on_the_card_picks_adam_by_backend(cuda_device,
                                                      monkeypatch, backend):
    """``make_train_step`` on CUDA leaves: with ``backend == "cuda"`` the
    step's Adam is the kernel (one launch counted, ``torch.optim.Adam.step``
    never called); on the plain route, ``backend == "torch"``, it is
    ``optimizer.step()`` (called once, no launch)."""
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        make_train_step,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.adam import adam

    calls = []
    real = torch.optim.Adam.step

    def counted(self, *args, **kwargs):
        calls.append(self)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.optim.Adam, "step", counted)
    params, target, scene, cam, tex, cfg = _glass_step(cuda_device)
    cfg = cfg.replace(backend=backend)
    p = {n: v.detach().clone().requires_grad_() for n, v in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=0.01, capturable=True)
    before = adam.launches
    make_train_step(InverseProblem(scene, cam, tex, cfg, target), opt)(p, 0)
    torch.cuda.synchronize()
    kernel = backend == "cuda"
    assert (adam.launches - before, calls) == (
        (1, []) if kernel else (0, [opt]))
    assert all(opt.state[v]["step"].item() == 1 for v in p.values())


def test_adam_kernel_two_calls_equal_bits(cuda_device):
    """The same state and gradients stepped twice from copies: the same
    bits (no order-dependent arithmetic)."""
    from cpuperformanceraytracer_tpu_torch.kernels.adam import adam_step

    copies, grads = _adam_pair(cuda_device, "main_720p", {})
    for leaves, opt in copies:
        for k in range(3):
            for p, g in zip(leaves, grads(k)):
                p.grad = g
            adam_step(opt)
    torch.cuda.synchronize()
    for x, y in zip(_adam_state_bits(*copies[0]), _adam_state_bits(*copies[1])):
        assert _bits_equal(x, y)


@pytest.mark.parametrize("case", ["amsgrad", "not_capturable", "float64_leaf",
                                  "too_many_leaves"])
def test_adam_kernel_raises_on_the_card(cuda_device, case):
    """A CUDA leaf with what the kernel does not implement raises; nothing
    falls back to torch's step."""
    from cpuperformanceraytracer_tpu_torch.kernels.adam import MAX_LEAVES, adam_step

    n = MAX_LEAVES + 1 if case == "too_many_leaves" else 2
    dtype = torch.float64 if case == "float64_leaf" else torch.float32
    leaves = [torch.ones(5, device=cuda_device, dtype=dtype).requires_grad_()
              for _ in range(n)]
    opt = torch.optim.Adam(leaves, capturable=case != "not_capturable",
                           amsgrad=case == "amsgrad")
    for p in leaves:
        p.grad = torch.ones_like(p)
    with pytest.raises(ValueError):
        adam_step(opt)
    assert all(torch.equal(p.detach(), torch.ones_like(p)) for p in leaves)


def test_one_replay_of_16_steps_counts_16_adam_launches(cuda_device):
    """One replay of a K = 16 training graph: 16 launches of Adam's kernel
    in ``profiling.replayed_launches()``, as many as of kernel A."""
    from cpuperformanceraytracer_tpu_torch.kernels.adam import adam
    from cpuperformanceraytracer_tpu_torch.utils import profiling

    step_k, p = _train_graph(cuda_device, k=16)
    step_k(p, 0)
    before = profiling.replayed_launches()
    step_k(p, 16)
    after = profiling.replayed_launches()
    torch.cuda.synchronize()
    made = {n: after.get(n, 0) - before.get(n, 0)
            for n in (adam.__name__, render_planes.__name__)}
    assert made == {"adam": 16, "render_planes": 16}


def test_zeroing_the_adam_state_restarts_the_job(cuda_device):
    """As the benchmark's jobs do: the params copied back and every
    ``optimizer.state[p]`` tensor zeroed in place, a replay of the same
    frames gives the first dispatch's losses and params, bit for bit."""
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        make_train_step_k,
    )

    params, target, scene, cam, tex, cfg = _glass_step(cuda_device)
    p = {n: v.detach().clone().requires_grad_() for n, v in params.items()}
    start = {n: v.detach().clone() for n, v in p.items()}
    opt = torch.optim.Adam(list(p.values()), lr=0.01, capturable=True)
    step_k = make_train_step_k(InverseProblem(scene, cam, tex, cfg, target),
                               opt, 3, resample_frames=True)
    first = step_k(p, 5).clone()
    after = {n: v.detach().clone() for n, v in p.items()}
    step_k(p, 8)
    with torch.no_grad():
        for n, v in p.items():
            v.copy_(start[n])
            for s in opt.state[v].values():
                s.zero_()
    again = step_k(p, 5)
    torch.cuda.synchronize()
    assert _bits_equal(first, again)
    for n in p:
        assert _bits_equal(after[n], p[n].detach()), n


# ---- the checkpoint's deflate (csrc/deflate.cu) ----------------------------

def _inflate(stream) -> bytes:
    import zlib

    z = zlib.decompressobj(-15)
    out = z.decompress(bytes(stream)) + z.flush()
    assert z.eof and not z.unused_data
    return out


def _deflate_bytes(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    count = -(-n // 4)
    plane = 0.4 + 0.3 * np.sin(np.linspace(0, 6, count)) \
        + 0.02 * rng.standard_normal(count)
    return plane.astype(np.float32).view(np.uint8)[:n].copy()


@pytest.mark.parametrize("kind", ["zeros", "random", "floats"])
def test_deflate_kernel_equals_plain(cuda_device, kind):
    """Bytes and CRC-32s, member for member, at small sizes: empty, one
    byte, a ragged tail, a whole slice."""
    import zlib

    from cpuperformanceraytracer_tpu_torch.kernels import deflate as dfl

    sizes = [2 * dfl.SLICE + 777, 0, 1, dfl.SLICE, 5000]
    data = np.concatenate([_deflate_bytes(kind, n, i)
                           for i, n in enumerate(sizes)])
    starts = [zlib.crc32(b"head"), 0, 7, 0xFFFFFFFF, 12345]
    before = dfl.deflate.launches
    got = dfl.deflate(torch.from_numpy(data).to(cuda_device), sizes,
                      starts).fetch()
    assert dfl.deflate.launches == before + 1
    want = dfl.deflate_reference(data, sizes, starts)
    at = 0
    for (g, gc), (w, wc), n, crc in zip(got, want, sizes, starts):
        assert gc == wc == zlib.crc32(data[at:at + n], crc)
        assert bytes(g) == w
        assert _inflate(g) == data[at:at + n].tobytes()
        at += n


def test_deflate_fetches_keep_their_own_bytes(cuda_device):
    """A fetch's streams stay whole while later calls fetch theirs, as two
    saves at once need."""
    from cpuperformanceraytracer_tpu_torch.kernels import deflate as dfl

    sizes = [dfl.SLICE + 99, 4000]
    data = [np.concatenate([_deflate_bytes(kind, n, i)
                            for i, n in enumerate(sizes)])
            for kind in ("floats", "zeros", "random")]
    got = [dfl.deflate(torch.from_numpy(d).to(cuda_device), sizes).fetch()
           for d in data]
    for d, streams in zip(data, got):
        assert b"".join(_inflate(s) for s, _ in streams) == d.tobytes()


def _saved_planes(path):
    with np.load(path, allow_pickle=False) as z:
        return np.stack([z["r"], z["g"], z["b"]]), int(z["frame"])


def test_deflated_save_round_trips_and_repeats(cuda_device, tmp_path,
                                               monkeypatch):
    """A CUDA save goes through the kernel, reads back bit-equal, and two
    saves of one accumulator are the same bytes; a save that fails, in
    the kernel's wrapper or in the write, leaves the checkpoint it had."""
    import zipfile

    from cpuperformanceraytracer_tpu_torch.io import checkpoint as ckpt
    from cpuperformanceraytracer_tpu_torch.kernels import deflate as dfl

    g = torch.Generator(device=cuda_device).manual_seed(3)
    acc = torch.rand((3, 300, 500), generator=g, device=cuda_device) * 2
    acc[:, :100] = 0.5                # a flat band the matches find
    cfg = RenderConfig(width=500, height=300, rng="counter")
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    before = dfl.deflate.launches
    ckpt.save_checkpoint(str(a), acc, 7, cfg)
    ckpt.save_checkpoint(str(b), acc, 7, cfg)
    assert dfl.deflate.launches == before + 2
    assert a.read_bytes() == b.read_bytes()
    planes, frame = _saved_planes(a)
    assert frame == 7
    assert np.array_equal(planes.view(np.uint32),
                          acc.cpu().numpy().view(np.uint32))
    with zipfile.ZipFile(a) as z:
        assert z.testzip() is None
    back, frame, saved = ckpt.load_checkpoint(str(a))
    assert frame == 7 and saved == cfg

    def failing_deflate(*args, **kw):
        raise RuntimeError("planted")

    def failing_write(f, entries):
        f.write(b"PK\x03\x04")
        raise RuntimeError("planted")

    for where, fault in ((dfl, ("deflate", failing_deflate)),
                         (ckpt, ("_write_zip", failing_write))):
        with monkeypatch.context() as m:
            m.setattr(where, *fault)
            with pytest.raises(RuntimeError, match="planted"):
                ckpt.save_checkpoint(str(a), acc * 2, 8, cfg)
        assert a.read_bytes() == b.read_bytes()
        assert sorted(p.name for p in tmp_path.iterdir()) == ["a.npz",
                                                              "b.npz"]


def test_deflated_4k_render_against_numpy(cuda_device, tmp_path):
    """A rendered 4K accumulator (config 5, 256 frames): its archive is
    within +1% of ``np.savez_compressed``'s bytes and reads back
    bit-equal; the kernel's time a save, in CUDA events."""
    import time

    from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu_torch.io import checkpoint as ckpt
    from cpuperformanceraytracer_tpu_torch.kernels import deflate as dfl

    cfg = BENCH_CONFIGS["offline_4k"].replace(num_frames=256)
    r = OfflineRenderer(cfg, texture=texture_from_array(
        gradient_sky(512, 256), cuda_device), silent=True)
    for _ in range(256):
        r.step()
    acc = r.accum
    torch.cuda.synchronize()
    path, plain = tmp_path / "c.npz", tmp_path / "numpy.npz"
    for _ in range(2):                  # the second save's time
        t0 = time.perf_counter()
        ckpt.save_checkpoint(str(path), acc, r.frame, r.cfg)
        save_s = time.perf_counter() - t0
    data = acc.contiguous().view(-1).view(torch.uint8)
    sizes = [data.numel() // 3] * 3
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    done = dfl.deflate(data, sizes)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end)
    planes = acc.cpu().numpy()
    t0 = time.perf_counter()
    np.savez_compressed(plain, version=ckpt.FORMAT_VERSION, frame=r.frame,
                        r=planes[0], g=planes[1], b=planes[2],
                        config="{}")
    numpy_s = time.perf_counter() - t0
    size, ref = path.stat().st_size, plain.stat().st_size
    print(f"4K save: {size} bytes against numpy's {ref} "
          f"({100 * (size / ref - 1):+.4f}%); save {save_s * 1e3:.1f} ms, "
          f"deflate launch to sizes {kernel_ms:.2f} ms, "
          f"numpy {numpy_s * 1e3:.0f} ms; streams "
          f"{sum(len(s) for s, _ in done.fetch())} bytes")
    assert size <= 1.01 * ref
    back, _ = _saved_planes(path)
    assert np.array_equal(back.view(np.uint32), planes.view(np.uint32))


def test_deflate_of_random_planes_stays_within_stored_bound(cuda_device):
    from cpuperformanceraytracer_tpu_torch.kernels import deflate as dfl

    g = torch.Generator(device=cuda_device).manual_seed(5)
    n = 2160 * 3840 * 4
    data = torch.randint(0, 256, (3 * n,), generator=g, dtype=torch.uint8,
                         device=cuda_device)
    got = dfl.deflate(data, [n] * 3).fetch()
    slices = -(-n // dfl.SLICE)
    for i, (stream, _) in enumerate(got):
        assert len(stream) <= n + 5 * slices
        assert _inflate(stream) == data[i * n:(i + 1) * n].cpu().numpy().tobytes()
