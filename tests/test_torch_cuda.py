"""The port's CUDA kernels vs their plain-torch versions on the card.

Every test needs a GPU (marker ``cuda``) and skips without one. The file
imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Strict tolerances (rtol 1e-4, atol 1e-5) hold for the diffuse cornell
box; the glass scene is held to the robust policy (a 1-ulp difference in
expf/atan2f can flip a lottery roll). Table cotangents of kernel C are
sums over pixels taken in another order than autograd's (shared
atomics): rtol 1e-3 with atol 1e-3 of the largest cotangent.
"""

import pytest
import torch

from torch_port_helpers import cuda_device, port_beer_scene  # noqa: F401  (fixture)
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff.benchgrad import default_bench_params
from cpuperformanceraytracer_tpu_torch.diff.grad import loss_and_grad, render_for_params
from cpuperformanceraytracer_tpu_torch.kernels.backward import (
    bwd_tables,
    bwd_tables_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
    env_accumulate,
    env_accumulate_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_backward import (
    env_backward,
    env_backward_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
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

    got_sum, want_sum = torch.zeros_like(got), torch.zeros_like(got)
    env_accumulate(planes, tex, cfg, got_sum, sum_into=True)
    env_accumulate_reference(planes, tex, cfg, want_sum, sum_into=True)
    torch.testing.assert_close(got_sum[:, same], want_sum[:, same],
                               rtol=1e-5, atol=0)


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
