"""K steps per dispatch on the CPU: the port's ``make_grad_step_k``,
``make_train_step_k`` and ``adam_inverse_render(steps_per_dispatch=K)``
against the JAX package's on the same parameters, both through their
oracle (JAX ``backend="xla"``, the port's ``"oracle"``), on the Beer scene
(every path refracts: no lottery decision can flip) at 32x8, 2 bounces,
the counter RNG and a stochastic env; plus ``fwd_bwd_benchmark``'s K and
the ``bench-grad --steps-per-dispatch`` flag.

Tolerances: losses rtol 1e-4; summed gradients rtol 2e-3 and atol 2e-3
of the key's largest reference gradient (the JAX diff tests' policy:
the two autodiffs sum over pixels in other orders); Adam parameters
atol 1e-5 (each step moves a parameter by about the learning rate,
0.01, times m / sqrt(v), which the gradients' last digits barely move).
On the card the K steps are one CUDA graph, held bit for bit to the
ungraphed steps by ``tests/test_torch_cuda.py``.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import beer_scene, port_cfg, port_scene
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.diff import benchgrad as jbench
from cpuperformanceraytracer_tpu.diff import inverse as jinv
from cpuperformanceraytracer_tpu.diff.grad import image_loss as jloss
from cpuperformanceraytracer_tpu.diff.grad import render_for_params as jrender
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu.scene.camera import make_camera
from cpuperformanceraytracer_tpu.scene.types import Material
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.app import cli
from cpuperformanceraytracer_tpu_torch.diff.benchgrad import (
    bench_loss,
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
    make_train_step_k,
)
from cpuperformanceraytracer_tpu_torch.io.convert import texture_from
from cpuperformanceraytracer_tpu_torch.utils.log import get_logger

K = 3
FRAME0 = 2
BEER = dict(width=32, height=8, bounces=2, rng="counter", jitter=True,
            roulette="off", env_mode="equirect", env_sampling="stochastic",
            backend="xla")


@pytest.fixture(scope="module")
def problem():
    """Both packages' Beer problem: (JAX scene, camera, texture, cfg,
    target), (port scene, camera, texture, cfg, target), the numpy
    albedo + 0.05 and sphere centers + 0.1."""
    jscene, jcam = beer_scene(SceneBuilder, Material, make_camera)
    jtex = texture_from_array(gradient_sky(64, 32))
    jcfg = JaxConfig(**BEER)
    jtarget = jrender({}, jscene, jcam, jtex, jcfg, 0)
    scene, cam = port_scene(jscene, jcam)
    tex = texture_from(jtex)
    cfg = port_cfg(jcfg, backend="oracle")
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    m, s = jscene.materials.albedo, jscene.spheres.center
    params = {"albedo": np.stack([np.asarray(c) for c in (m.x, m.y, m.z)], -1)
              + np.float32(0.05),
              "sphere_centers": np.stack([np.asarray(c) for c in (s.x, s.y,
                                                                   s.z)], -1)
              + np.float32(0.1)}
    return ((jscene, jcam, jtex, jcfg, jtarget),
            (scene, cam, tex, cfg, target),
            {k: v.astype(np.float32) for k, v in params.items()})


def _close_grads(got, want):
    for key, a in want.items():
        a, b = np.asarray(a), got[key].numpy()
        assert np.abs(a).max() > 0.0, f"{key}: the reference is all zero"
        np.testing.assert_allclose(b, a, rtol=2e-3,
                                   atol=2e-3 * np.abs(a).max(), err_msg=key)


def test_grad_step_k_matches_jax(problem):
    """grad_sum and losses of K steps at frames FRAME0 .. FRAME0 + K - 1;
    the port's grad_sum is exactly the in-order sum of its K steps."""
    (js, jc, jt, jcfg, jtarget), (s, c, t, cfg, target), params = problem

    def jloss_fn(p, frame):
        return jloss(jrender(p, js, jc, jt, jcfg, frame), jtarget)

    want_sum, want_losses = jbench.make_grad_step_k(jloss_fn, K)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.uint32(FRAME0))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got_sum, got_losses = make_grad_step_k(bench_loss(cfg, s, c, t), K)(
        tparams, FRAME0)
    assert got_losses.shape == (K,)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                               rtol=1e-4)
    _close_grads(got_sum, want_sum)
    steps = [loss_and_grad(tparams, target, s, c, t, cfg, FRAME0 + i)
             for i in range(K)]
    for key in tparams:
        total = torch.zeros_like(tparams[key])
        for _, g in steps:
            total = total + g[key]
        assert torch.equal(got_sum[key], total), key
    assert torch.equal(got_losses, torch.stack([loss for loss, _ in steps]))


def test_train_step_k_matches_optax(problem):
    """K Adam steps on fresh sample sets (resample_frames) from one
    dispatch: the parameters and losses of JAX's lax.scan with
    optax.adam."""
    (js, jc, jt, jcfg, jtarget), (s, c, t, cfg, target), params = problem
    opt = optax.adam(0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp, _, want_losses = jinv.make_train_step_k(
        jinv.InverseProblem(js, jc, jt, jcfg, jtarget), opt, K,
        resample_frames=True)(jp, opt.init(jp), jnp.uint32(FRAME0))
    # copies: Adam updates them in place
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    adam = torch.optim.Adam(list(tp.values()), lr=0.01)
    got_losses = make_train_step_k(InverseProblem(s, c, t, cfg, target), adam,
                                   K, resample_frames=True)(tp, FRAME0)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                               rtol=1e-4)
    for key in params:
        moved = np.abs(np.asarray(jp[key]) - params[key]).max()
        assert moved > 0.01, key
        np.testing.assert_allclose(tp[key].detach().numpy(),
                                   np.asarray(jp[key]), rtol=0, atol=1e-5,
                                   err_msg=key)


def test_adam_inverse_render_chunks_log_as_jax(problem, caplog):
    """10 steps at K = 4 (chunks of 4, 4 and a tail of 2): the logged
    steps and their losses, and every loss, as JAX's."""
    (js, jc, jt, jcfg, jtarget), (s, c, t, cfg, target), params = problem
    init = {"albedo": params["albedo"]}
    jlog = logging.getLogger("kstep_jax")
    caplog.set_level(logging.INFO)
    _, want = jinv.adam_inverse_render(
        jinv.InverseProblem(js, jc, jt, jcfg, jtarget),
        {"albedo": jnp.asarray(init["albedo"])}, steps=10,
        learning_rate=0.02, log_every=5, logger=jlog, steps_per_dispatch=4)
    _, got = adam_inverse_render(
        InverseProblem(s, c, t, cfg, target),
        {"albedo": torch.from_numpy(init["albedo"])}, steps=10,
        learning_rate=0.02, log_every=5, logger=get_logger(),
        steps_per_dispatch=4)

    def logged(name):
        return [r.getMessage().split() for r in caplog.records
                if r.name == name]

    jl, tl = logged("kstep_jax"), logged("cprt_torch")
    assert [x[2] for x in tl] == [x[2] for x in jl] == ["0", "5"]
    np.testing.assert_allclose([float(x[4]) for x in tl],
                               [float(x[4]) for x in jl], rtol=1e-4)
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_fwd_bwd_benchmark_reports_k(problem):
    """K = 2 on the CPU: 4 timed steps in 2 spans of one dispatch each."""
    _, (s, c, t, cfg, _), _ = problem
    r = fwd_bwd_benchmark(cfg, s, c, t, steps=4, steps_per_dispatch=2,
                          warmup_calls=1, spans=2)
    assert r["steps_per_dispatch"] == 2 and r["steps_timed"] == 4
    assert r["grads_finite"] and len(r["span_ms"]) == 2


@pytest.mark.parametrize("backend,flags,k,steps", [
    ("torch", ["--steps", "4", "--steps-per-dispatch", "2"], 2, 4),
    ("oracle", [], 1, 4),
])
def test_cli_bench_grad_steps_per_dispatch(capsys, backend, flags, k, steps):
    """``--steps-per-dispatch`` reaches the bench; the oracle's defaults
    are JAX's ``xla`` ones: 4 steps, K = 1, path replay."""
    args = ["bench-grad", "--width", "32", "--height", "8", "--bounces", "1",
            "--env", "procedural", "--backend", backend, *flags]
    assert cli.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["steps_per_dispatch"] == k and out["steps_timed"] == steps
    assert out["grads_finite"] and out["config"].endswith(backend)


def test_device_frame_renders_as_its_int():
    """A ``DeviceFrame`` (base tensor + baked offset, what a CUDA graph
    replays) keys the RNG as the int base + offset, on the plain kernel A
    and the plain kernel C."""
    from torch_port_helpers import port_beer_scene
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.kernels.backward import bwd_tables
    from cpuperformanceraytracer_tpu_torch.core.rng import DeviceFrame
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
    )

    scene, cam = port_beer_scene()
    cfg = RenderConfig(width=32, height=8, bounces=2, rng="counter",
                       backend="torch")
    tables = pack_tables(scene, cam, cfg, "cpu")
    frame = DeviceFrame(torch.tensor([5], dtype=torch.int32), 2)
    assert torch.equal(render_planes(tables, cfg, frame),
                       render_planes(tables, cfg, 7))
    assert not torch.equal(render_planes(tables, cfg, frame),
                           render_planes(tables, cfg, 2))
    cot6 = torch.from_numpy(np.random.RandomState(3).randn(6, 8, 32)
                            .astype(np.float32))
    for a, b in zip(bwd_tables(tables, cfg, frame, 0, cot6),
                    bwd_tables(tables, cfg, 7, 0, cot6)):
        assert torch.equal(a, b)


def test_fixed_quad_table_renders_as_a_fresh_derivation():
    """The per-step packing: a loss built once derives the scene's quad
    table once (``fixed_quad_table``); a step that takes it renders and
    differentiates bit-equal to one that derives the table, and params
    that move a quad derive the table anew (a wrong table changes the
    image of the first and not of the second)."""
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.diff.grad import (
        fixed_quad_table,
        image_loss,
        render_for_params,
        value_and_grad,
    )
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    scene, cam = scene_by_name("cornell_box")
    cfg = RenderConfig(width=32, height=16, bounces=2, rng="counter",
                       env_mode="none", backend="torch")
    table = fixed_quad_table(scene)
    assert not table.requires_grad
    wrong = table.clone()
    wrong[:, 0:3] += 0.25
    with torch.no_grad():
        target = render_for_params({}, scene, cam, None, cfg, 0)
    m, q = scene.materials.albedo, scene.quads.v0

    def loss(tbl):
        return lambda p: image_loss(render_for_params(p, scene, cam, None,
                                                      cfg, 1, tbl), target)

    for params, uses_table in (
            ({"albedo": torch.stack([m.x, m.y, m.z], -1) + 0.05}, True),
            ({"quad_v0": torch.stack([q.x, q.y, q.z], -1) + 0.01}, False)):
        (name,) = params
        got, want = value_and_grad(loss(table), params), value_and_grad(
            loss(None), params)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1][name], want[1][name])
        off = value_and_grad(loss(wrong), params)[0]
        assert torch.equal(off, want[0]) != uses_table
