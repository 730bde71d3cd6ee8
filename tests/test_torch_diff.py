"""The training slice: the port's ``loss_and_grad(backend="torch")`` (the
plain versions under autograd) vs the JAX ``loss_and_grad`` through the
XLA oracle, plus the diff modules' own checks.

- the Beer scene (every path refracts: decision-stable, with sphere
  gradients through Beer absorption) for albedo, sphere centers and
  radii and every env texel: strict, rtol 2e-3 and atol 2e-3 of the
  key's largest reference gradient (``tests/test_diff_pallas.py``);
- glass_spheres + env at 128x16, 2 bounces, roulette v4_quirk: finite,
  per-key norms within 5% (a 1-ulp difference may flip a lottery path);
- finite differences, ``apply_params``, Adam vs optax, the benchmark and
  inverse loops, ``DiffSample``'s wiring and the CLI, port only where
  not stated.

Each oracle call (about 15 s here) runs once, in a module fixture.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import beer_scene, jax_cfg, port_cfg, port_scene
from cpuperformanceraytracer_tpu.diff import grad as jgrad
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu.scene.camera import make_camera
from cpuperformanceraytracer_tpu.scene.presets import glass_spheres_scene
from cpuperformanceraytracer_tpu.scene.types import Material
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.app import cli
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
    default_bench_params,
    fwd_bwd_benchmark,
)
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    apply_params,
    image_loss,
    loss_and_grad,
    render_for_params,
)
from cpuperformanceraytracer_tpu_torch.diff.inverse import (
    InverseProblem,
    adam_inverse_render,
)
from cpuperformanceraytracer_tpu_torch.io.convert import texture_from
from cpuperformanceraytracer_tpu_torch.kernels.backward import (
    DiffSample,
    render_frame_diff,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    pack_camera,
    pack_scene,
)

FRAME = 1
# 3 bounces: the camera does not see the floor at this aspect, so its
# albedo reaches the image only through a refracted path that lands on
# the floor and still has a segment left to reach the sky
BEER = dict(width=128, height=32, bounces=3, rng="counter", jitter=True,
            roulette="off", env_mode="equirect", env_sampling="stochastic")
GLASS = dict(scene="glass_spheres", width=128, height=16, bounces=2,
             rng="counter", jitter=True, roulette="v4_quirk",
             env_mode="equirect", env_sampling="stochastic")


def _stack(*vs):
    return np.stack([np.asarray(v) for v in vs], -1).astype(np.float32)


def _np_params(jscene, jtex, radii=False):
    m, s = jscene.materials.albedo, jscene.spheres.center
    p = {"albedo": _stack(m.x, m.y, m.z) + np.float32(0.05),
         "sphere_centers": _stack(s.x, s.y, s.z) + np.float32(0.1),
         "env_rgb": _stack(jtex.r, jtex.g, jtex.b)}
    if radii:
        p["sphere_radii"] = np.asarray(jscene.spheres.radius,
                                       np.float32) + np.float32(0.05)
    return p


def _compare(jscene, jcam, jtex, jcfg, params):
    """(port loss, port grads, JAX oracle loss, JAX oracle grads), both
    against the oracle's target at frame 0."""
    xcfg = jcfg.replace(backend="xla")
    target = jgrad.render_for_params({}, jscene, jcam, jtex, xcfg, 0)
    lx, gx = jgrad.loss_and_grad({k: jnp.asarray(v) for k, v in params.items()},
                                 target, jscene, jcam, jtex, xcfg, FRAME)
    scene, cam = port_scene(jscene, jcam)
    tex = texture_from(jtex)
    lt, gt = loss_and_grad({k: torch.from_numpy(v) for k, v in params.items()},
                           torch.from_numpy(np.stack([np.asarray(c) for c in target])),
                           scene, cam, tex, port_cfg(jcfg), FRAME)
    return (float(lt), {k: v.numpy() for k, v in gt.items()}, float(lx),
            {k: np.asarray(v) for k, v in gx.items()})


@pytest.fixture(scope="module")
def beer_grads():
    jscene, jcam = beer_scene(SceneBuilder, Material, make_camera)
    jtex = texture_from_array(gradient_sky(64, 32))
    return _compare(jscene, jcam, jtex, jax_cfg(**BEER),
                    _np_params(jscene, jtex, radii=True))


@pytest.fixture(scope="module")
def glass_grads():
    jscene, jcam = glass_spheres_scene()
    jtex = texture_from_array(gradient_sky(64, 32))
    params = _np_params(jscene, jtex)
    return _compare(jscene, jcam, jtex, jax_cfg(**GLASS), params)


@pytest.mark.parametrize("key", ["albedo", "sphere_centers", "sphere_radii",
                                 "env_rgb"])
def test_beer_grads_match_oracle(beer_grads, key):
    lt, gt, lx, gx = beer_grads
    np.testing.assert_allclose(lt, lx, rtol=1e-4)
    a, b = gx[key], gt[key]
    assert np.isfinite(b).all()
    assert np.abs(a).max() > 0.0, f"{key}: the reference is all zero"
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3 * np.abs(a).max(),
                               err_msg=key)


@pytest.mark.parametrize("key", ["albedo", "env_rgb"])
def test_glass_grads_finite_and_close(glass_grads, key):
    lt, gt, lx, gx = glass_grads
    np.testing.assert_allclose(lt, lx, rtol=1e-3)
    a, b = gx[key], gt[key]
    assert np.isfinite(b).all()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    assert na > 0.0, f"{key}: the reference is all zero"
    assert abs(na - nb) <= 0.05 * na, (key, na, nb)


# 2 bounces at 64x32: the Beer sphere's geometry gradient, and env texels
# of a six-face 8x8 cubemap seen around it
CUBE = dict(width=64, height=32, bounces=2, rng="counter", jitter=True,
            roulette="off", env_mode="cubemap")


@pytest.fixture(scope="module", params=["stochastic", "nearest"])
def cube_grads(request):
    """The port's plain diff path with a cubemap env vs the JAX oracle:
    one oracle call per sampling."""
    jscene, jcam = beer_scene(SceneBuilder, Material, make_camera)
    faces = np.random.RandomState(8).rand(6 * 8, 8, 3).astype(np.float32)
    jtex = texture_from_array(faces + np.float32(0.25))
    return _compare(jscene, jcam, jtex,
                    jax_cfg(**CUBE, env_sampling=request.param),
                    _np_params(jscene, jtex, radii=True))


@pytest.mark.parametrize("key", ["env_rgb", "sphere_centers", "sphere_radii"])
def test_cubemap_grads_match_oracle(cube_grads, key):
    """The diff path takes a cubemap (the JAX Pallas backward does, through
    texture.py:406-423): env-texel and geometry gradients as the oracle's."""
    lt, gt, lx, gx = cube_grads
    np.testing.assert_allclose(lt, lx, rtol=1e-4)
    a, b = gx[key], gt[key]
    assert np.isfinite(b).all()
    assert np.abs(a).max() > 0.0, f"{key}: the reference is all zero"
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3 * np.abs(a).max(),
                               err_msg=key)


def test_glass_sphere_center_grads_zero_on_both_sides(glass_grads):
    """At 2 bounces a glass path has too few segments for Beer absorption
    to carry a geometry gradient: the oracle's sphere-center gradient is
    exactly 0 here (the Beer scene above checks a nonzero one), and the
    port's must be too."""
    _, gt, _, gx = glass_grads
    assert not np.any(gx["sphere_centers"])
    assert not np.any(gt["sphere_centers"])


def _port_beer(width=128, height=32):
    from torch_port_helpers import port_beer_scene
    from cpuperformanceraytracer_tpu_torch.texture.procedural import (
        gradient_sky as port_sky,
    )
    from cpuperformanceraytracer_tpu_torch.texture.texture import (
        texture_from_array as port_tex,
    )

    scene, cam = port_beer_scene()
    cfg = RenderConfig(width=width, height=height, bounces=3, rng="counter",
                       roulette="off", backend="torch")
    return scene, cam, port_tex(port_sky(64, 32)), cfg


def test_finite_differences_albedo_and_env():
    """Central differences on the floor's green albedo and the env texel
    with the largest gradient (both enter smoothly)."""
    scene, cam, tex, cfg = _port_beer()
    params = {k: v.clone() for k, v in
              default_bench_params(scene, tex).items() if k != "sphere_centers"}
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)

    def loss(p):
        with torch.no_grad():
            return float(image_loss(render_for_params(p, scene, cam, tex, cfg,
                                                      FRAME), target))

    _, grads = loss_and_grad(params, target, scene, cam, tex, cfg, FRAME)
    texel = int(grads["env_rgb"][:, 1].abs().argmax())
    eps = 1e-2
    for key, index in (("albedo", (0, 1)), ("env_rgb", (texel, 1))):
        an = float(grads[key][index])
        assert an != 0.0, key
        up, dn = params[key].clone(), params[key].clone()
        up[index] += eps
        dn[index] -= eps
        fd = (loss({**params, key: up}) - loss({**params, key: dn})) / (2 * eps)
        assert abs(fd - an) < 2e-3 + 0.05 * abs(fd), (key, fd, an)


def test_apply_params_matches_jax():
    jscene, _ = glass_spheres_scene()
    jtex = texture_from_array(gradient_sky(16, 8))
    rng = np.random.RandomState(2)
    nq, ns, nm = 4, 7, 11
    params = {"sphere_centers": rng.randn(ns, 3), "sphere_radii": rng.rand(ns),
              "quad_v0": rng.randn(nq, 3), "quad_v2": rng.randn(nq, 3),
              "albedo": rng.rand(nm, 3), "refraction_color": rng.rand(nm, 3),
              "ior": rng.rand(nm) + 1.0, "specular_roughness": rng.rand(nm),
              "env_rgb": rng.rand(16 * 8, 3)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    js, jt = jgrad.apply_params(jscene, jtex,
                                {k: jnp.asarray(v) for k, v in params.items()})
    scene, _ = port_scene(jscene, make_camera())
    ps, pt = apply_params(scene, texture_from(jtex),
                          {k: torch.from_numpy(v) for k, v in params.items()})
    want = jax.tree.leaves((js, (jt.r, jt.g, jt.b)))
    got = jax.tree.leaves((ps, (pt.r, pt.g, pt.b)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float64),
                                      np.asarray(w, np.float64))


@pytest.mark.parametrize("eps", [1e-8, 1e-2])
def test_adam_matches_optax(eps):
    """torch's Adam and optax's adam both add eps outside the square root
    of the bias-corrected second moment: 5 steps on one gradient
    sequence agree to rtol 1e-6."""
    rng = np.random.RandomState(4)
    p0 = (1.0 + rng.rand(7, 3)).astype(np.float32)
    grads = [rng.randn(7, 3).astype(np.float32) * 10 ** -k for k in range(5)]
    opt = optax.adam(0.01, eps=eps)
    p = jnp.asarray(p0)
    state = opt.init(p)
    t = torch.tensor(p0, requires_grad=True)
    adam = torch.optim.Adam([t], lr=0.01, eps=eps)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        t.grad = torch.from_numpy(g)
        adam.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(p), rtol=1e-6)


def test_fwd_bwd_benchmark_tiny():
    scene, cam, tex, cfg = _port_beer(32, 8)
    r = fwd_bwd_benchmark(cfg.replace(bounces=1), scene, cam, tex, steps=2,
                          warmup_steps=1, spans=2)
    assert set(r) == {"ms_per_step", "Mrays_per_s", "span_ms", "spread",
                      "steps_timed", "loss", "grads_finite", "param_leaves"}
    assert r["grads_finite"] and r["steps_timed"] == 2
    assert r["ms_per_step"] > 0 and r["Mrays_per_s"] > 0
    assert len(r["span_ms"]) == 2 and r["spread"] >= 0.0
    assert r["param_leaves"] == ["albedo", "env_rgb", "sphere_centers"]


def test_adam_inverse_render_loss_falls():
    scene, cam, tex, cfg = _port_beer(64, 16)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    m = scene.materials.albedo
    init = {"albedo": torch.clamp(torch.stack([m.x, m.y, m.z], -1) + 0.1,
                                  0.0, 1.0)}
    params, losses = adam_inverse_render(
        InverseProblem(scene, cam, tex, cfg, target), init, steps=5,
        learning_rate=0.02)
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert params["albedo"].shape == init["albedo"].shape
    assert not params["albedo"].requires_grad


def test_adam_inverse_render_logs_at_jax_steps(caplog):
    """JAX's progress lines: ``inverse step %d loss %.6f`` at steps 0,
    log_every, 2 * log_every, ... with that step's loss."""
    from cpuperformanceraytracer_tpu_torch.utils.log import get_logger

    scene, cam, tex, cfg = _port_beer(32, 8)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    m = scene.materials.albedo
    init = {"albedo": torch.stack([m.x, m.y, m.z], -1) + 0.1}
    caplog.set_level(logging.INFO, logger="cprt_torch")
    _, losses = adam_inverse_render(
        InverseProblem(scene, cam, tex, cfg, target), init, steps=12,
        learning_rate=0.02, log_every=5, logger=get_logger())
    lines = [r.getMessage() for r in caplog.records if r.name == "cprt_torch"]
    assert lines == [f"inverse step {i} loss {losses[i]:.6f}" for i in (0, 5, 10)]


@pytest.mark.parametrize("silent", [False, True])
def test_cli_inverse_logs_every_10_steps(caplog, capsys, silent):
    caplog.set_level(logging.INFO, logger="cprt_torch")
    args = ["inverse", "--width", "32", "--height", "8", "--bounces", "1",
            "--backend", "torch", "--env", "none", "--steps", "11"]
    assert cli.main(args + ["--silent"] * silent) == 0
    assert capsys.readouterr().out.startswith("inverse render: loss ")
    steps = [r.getMessage().split()[2] for r in caplog.records
             if r.name == "cprt_torch"
             and r.getMessage().startswith("inverse step ")]
    assert steps == ([] if silent else ["0", "10"])


def test_diff_sample_wiring_on_cpu():
    """DiffSample on CPU tensors runs the wrappers' plain versions (A, B
    forward; D, C backward): the plain path's loss and gradients, exactly."""
    scene, cam, tex, cfg = _port_beer(64, 16)
    params = default_bench_params(scene, tex)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)

    def grads(render):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        s, t = apply_params(scene, tex, p)
        loss = image_loss(render(s, t), target)
        return loss.item(), torch.autograd.grad(loss, list(p.values()))

    def via_function(s, t):
        quad, sph, mat = (x.contiguous() for x in pack_scene(s))
        return DiffSample.apply(cfg, FRAME, 0, (t.width, t.height), quad, sph,
                                mat, pack_camera(cam, cfg), t.r.contiguous(),
                                t.g.contiguous(), t.b.contiguous())

    la, ga = grads(lambda s, t: render_for_params({}, s, cam, t, cfg, FRAME))
    lb, gb = grads(via_function)
    assert la == lb
    for a, b in zip(ga, gb):
        assert a.abs().max() > 0
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: nothing to refuse")
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    assert RenderConfig().backend == "cuda"
    scene, cam = scene_by_name("cornell_box")
    cfg = RenderConfig(width=32, height=8, env_mode="none", rng="counter")
    for call in (lambda: OfflineRenderer(cfg),
                 lambda: render_frame_diff(scene, cam, None, cfg, 0),
                 lambda: fwd_bwd_benchmark(cfg, scene, cam, None, steps=1)):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            call()
    with pytest.raises(ValueError, match="counter"):
        render_for_params({}, scene, cam, None, cfg.replace(
            rng="wang", backend="torch"), 0)


def test_cli_bench_grad_and_inverse(capsys):
    common = ["--width", "32", "--height", "8", "--bounces", "1",
              "--backend", "torch"]
    assert cli.main(["bench-grad", *common, "--steps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["metric"] == "fwd_bwd_ms_per_step" and out["grads_finite"]
    assert out["config"] == "32x8 spp1 b1 env=equirect torch"
    assert cli.main(["inverse", *common, "--env", "none", "--steps", "2"]) == 0
    assert capsys.readouterr().out.startswith("inverse render: loss ")
    assert cli.main(["inverse", *common, "--env-sampling", "bilinear"]) == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error: ") and "bilinear" in err and "\n" not in err
