"""The port's parallel layer on the CPU: worlds of 2 and 4 gloo ranks
spawned by ``parallel.mesh.spawn_world``, held to the port's unsharded
frame and step and to the JAX package (the cases of
``tests/test_sharding.py`` and ``tests/test_parallel_extras.py``).

- pixel-row sharding: bit-equal to the unsharded frame of the same
  backend ("torch", "oracle"; wang and counter) on 2 and 4 ranks, and
  within JAX's atol 1e-5 of its ``render_frame``;
- sample sharding: within 1e-5 (1e-4 with a texture) of the unsharded
  frame and of JAX's;
- the frame fn, the K-frame fn and the sharded ``OfflineRenderer``
  against their unsharded counterparts, and the validation errors;
- the training step on (2, 1), (1, 2) and (2, 2) meshes: loss and per-key
  gradient norm and sum within JAX's tolerances of JAX's unsharded
  ``jax.value_and_grad`` (its XLA route), close to the port's unsharded
  step, bit-equal on a second run, and the elements its collectives move
  equal to ``parallel/budget.training_step_comm_elements``;
- the scaling harness, the ownership images, the throughput report and
  the profiler's trace.

Each world is spawned once (a module fixture) and runs every case of
its size; a spawned rank imports this module, so JAX is imported inside
the tests only.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_helpers import port_cfg  # noqa: F401  (sets 1 thread)
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff.grad import loss_and_grad
from cpuperformanceraytracer_tpu_torch.parallel import budget, shard
from cpuperformanceraytracer_tpu_torch.parallel.mesh import (
    default_mesh,
    init_distributed,
    make_mesh,
    spawn_world,
)
from cpuperformanceraytracer_tpu_torch.parallel.scaling import measure_scaling
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.render.frame import make_frame_fn
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

BASE = dict(width=32, height=24, spp=2, bounces=2, scene="cornell_box",
            env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
            jitter=True, roulette="off", rng="counter", num_frames=3,
            warmup_frames=0)
FRAME = 3
PX_CASES = [(b, r) for b in ("torch", "oracle") for r in ("wang", "counter")]
TEXTURED = dict(env_mode="equirect", env_sampling="stochastic", spp=8)
PX_SPP = dict(spp=4)
# the problem of tests/test_parallel_extras.py's training step
TRAIN = dict(width=64, height=48, spp=2, bounces=2, env_mode="equirect",
             env_sampling="stochastic", env_flip_xz=True)
TRAIN_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


def _cfg(**kw) -> RenderConfig:
    return RenderConfig(**{**BASE, "backend": "torch", **kw})


def _jax_cfg(**kw):
    from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig

    return JaxConfig(**{**BASE, "backend": "xla", **kw})


def _texture():
    return texture_from_array(gradient_sky(32, 16))


def _train_texture():
    return texture_from_array(gradient_sky(16, 8))


def _unsharded(cfg, texture=None, frame=FRAME):
    """The port's unsharded frame: colour (blend 1 into zeros)."""
    scene, cam = scene_by_name(cfg.scene)
    acc = torch.zeros((3, cfg.height, cfg.width))
    return make_frame_fn(cfg, scene, cam, "cpu")(texture, frame, acc, 1.0)


# ---- what each rank of a world runs ----------------------------------------

def _frame(cfg, shape, texture=None):
    scene, cam = scene_by_name(cfg.scene)
    return shard.sharded_render_frame(scene, cam, texture, cfg, FRAME,
                                      make_mesh(shape))


def _accumulated(cfg, mesh, k=None):
    scene, cam = scene_by_name(cfg.scene)
    acc = torch.zeros((3, cfg.height, cfg.width))
    if k is not None:
        return shard.make_sharded_multi_frame_fn(cfg, mesh, k)(
            scene, cam, None, 0, acc)
    step = shard.make_sharded_frame_fn(cfg, mesh)
    for f in range(cfg.num_frames):
        acc = step(scene, cam, None, f, acc)
    return acc


def _errors(n):
    """The validation errors, each caught on the rank."""
    scene, cam = scene_by_name("cornell_box")
    px, spp = make_mesh((n, 1)), default_mesh(spp_shards=2)
    out = {}
    cases = {"height": (_cfg(height=25), shard.sharded_render_frame, px),
             "wang": (_cfg(rng="wang"), shard.sharded_render_frame, spp),
             "spp": (_cfg(spp=3), shard.sharded_render_frame, spp),
             "diff_wang": (_cfg(rng="wang"), shard.sharded_render_frame_diff,
                           px)}
    for name, (cfg, fn, mesh) in cases.items():
        try:
            fn(scene, cam, None, cfg, 0, mesh)
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def _train(shape, params, target, twice=False):
    """One sharded training step: (loss, grads, elements moved)."""
    cfg = _cfg(**TRAIN)
    scene, cam = scene_by_name(cfg.scene)
    mesh = make_mesh(shape)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    shard.comm_elements = 0
    loss, grads = shard.sharded_loss_and_grad(
        p, torch.from_numpy(target), scene, cam, _train_texture(), cfg, FRAME,
        mesh)
    out = {"loss": loss, "grads": grads, "elements": shard.comm_elements}
    if twice:
        again = shard.sharded_loss_and_grad(
            p, torch.from_numpy(target), scene, cam, _train_texture(), cfg,
            FRAME, mesh)
        out["again"] = again
    return out


def _world(n, params, target):
    """Every case of a world of ``n`` ranks; its results by name."""
    out = {"px": {case: _frame(_cfg(backend=case[0], rng=case[1]), (n, 1))
                  for case in PX_CASES}}
    px_mesh = make_mesh((n, 1))
    out["frame_fn_px"] = _accumulated(_cfg(), px_mesh)
    out["multi_px"] = _accumulated(_cfg(), px_mesh, k=4)
    r = OfflineRenderer(_cfg(num_frames=2), silent=True, mesh=px_mesh)
    r.run()
    out["driver_px"] = r.accum
    out["errors"] = _errors(n)
    for shape in TRAIN_MESHES[n]:
        out[("train", shape)] = _train(shape, params, target,
                                       twice=shape == (2, 1))
    if n == 2:
        out["spp_only"] = _frame(_cfg(**PX_SPP), (1, 2))
        return out
    mesh = default_mesh(spp_shards=2)
    out["px_spp"] = _frame(_cfg(**PX_SPP), (2, 2))
    out["textured"] = _frame(_cfg(**TEXTURED), (1, 4), _texture())
    out["frame_fn_px_spp"] = _accumulated(_cfg(), mesh)
    out["multi_px_spp"] = _accumulated(_cfg(), mesh, k=4)
    r = OfflineRenderer(_cfg(num_frames=2), silent=True, mesh=mesh)
    r.run()
    out["driver_px_spp"] = r.accum
    return out


# ---- the parent's references ------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    """The training step's params and target (the JAX test's: albedo +
    0.05, sphere centers + 0.1, every env texel; the XLA oracle's frame 0)
    and JAX's unsharded loss and gradients at frame 3."""
    import jax
    import jax.numpy as jnp

    from cpuperformanceraytracer_tpu.diff.grad import image_loss, render_for_params
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name as jscene
    from cpuperformanceraytracer_tpu.texture.procedural import (
        gradient_sky as jsky,
    )
    from cpuperformanceraytracer_tpu.texture.texture import (
        texture_from_array as jtex,
    )

    cfg = _jax_cfg(**TRAIN)
    scene, cam = jscene(cfg.scene)
    tex = jtex(jsky(16, 8))
    target = render_for_params({}, scene, cam, tex, cfg, 0)
    m, c = scene.materials.albedo, scene.spheres.center
    params = {"albedo": np.stack([m.x, m.y, m.z], -1) + np.float32(0.05),
              "sphere_centers": np.stack([c.x, c.y, c.z], -1) + np.float32(0.1),
              "env_rgb": np.stack([tex.r, tex.g, tex.b], -1)}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}

    def loss_fn(p):
        return image_loss(render_for_params(p, scene, cam, tex, cfg, FRAME),
                          target)

    loss, grads = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()})
    target = np.stack([np.asarray(t) for t in target]).astype(np.float32)
    return params, target, float(loss), {k: np.asarray(v, np.float64)
                                         for k, v in grads.items()}


@pytest.fixture(scope="module")
def world2(problem):
    return spawn_world(_world, 2, (2, *problem[:2]), threads=1, timeout=300)


@pytest.fixture(scope="module")
def world4(problem):
    return spawn_world(_world, 4, (4, *problem[:2]), threads=1, timeout=300)


@pytest.fixture
def world(request):
    return request.getfixturevalue(request.param)


def _jax_frame(texture=False, **kw):
    from cpuperformanceraytracer_tpu.render.frame import render_frame
    from cpuperformanceraytracer_tpu.scene.presets import cornell_box_scene
    from cpuperformanceraytracer_tpu.texture.procedural import (
        gradient_sky as jsky,
    )
    from cpuperformanceraytracer_tpu.texture.texture import (
        texture_from_array as jtex,
    )

    scene, cam = cornell_box_scene()
    color = render_frame(scene, cam, jtex(jsky(32, 16)) if texture else None,
                         _jax_cfg(**kw), FRAME)
    return np.stack([np.asarray(c) for c in color])


# ---- tests --------------------------------------------------------------------

def test_mesh_of_one_process():
    """Without a process group the world is one rank: ``init_distributed``
    is a no-op for one process, and a mesh must hold exactly the world."""
    init_distributed(None, 1, 0)
    mesh = make_mesh((1, 1))
    assert (mesh.rank, mesh.px, mesh.spp, mesh.size) == (0, 0, 0, 1)
    assert mesh.shape == {"px": 1, "spp": 1} and mesh.spp_group is None
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh((2, 1))
    with pytest.raises(ValueError, match="not divisible"):
        default_mesh(spp_shards=2)
    with pytest.raises(ValueError, match="axes"):
        make_mesh((1, 1), ("px", "rows"))


@pytest.mark.parametrize("world", ["world2", "world4"], indirect=True)
@pytest.mark.parametrize("backend,rng", PX_CASES)
def test_px_only_sharding_bit_equal(world, backend, rng):
    want = _unsharded(_cfg(backend=backend, rng=rng))
    for rank in world:
        assert torch.equal(rank["px"][(backend, rng)], want)


def test_px_only_sharding_matches_jax(world4):
    np.testing.assert_allclose(world4[0]["px"][("oracle", "counter")].numpy(),
                               _jax_frame(), atol=1e-5)


@pytest.mark.parametrize("world,key,kw,atol", [
    ("world2", "spp_only", PX_SPP, 1e-5),
    ("world4", "px_spp", PX_SPP, 1e-5),
    ("world4", "textured", TEXTURED, 1e-4)], indirect=["world"])
def test_spp_sharding_matches(world, key, kw, atol):
    texture = _texture() if "env_mode" in kw else None
    want = _unsharded(_cfg(**kw), texture)
    jax_want = _jax_frame(texture is not None, **kw)
    for rank in world:
        np.testing.assert_allclose(rank[key].numpy(), want.numpy(), atol=atol)
        np.testing.assert_allclose(rank[key].numpy(), jax_want, atol=atol)


def _unsharded_accum(cfg, frames):
    scene, cam = scene_by_name(cfg.scene)
    acc = torch.zeros((3, cfg.height, cfg.width))
    step = make_frame_fn(cfg, scene, cam, "cpu")
    for f in range(frames):
        step(None, f, acc)
    return acc


@pytest.mark.parametrize("world,key", [("world2", "frame_fn_px"),
                                       ("world4", "frame_fn_px"),
                                       ("world4", "frame_fn_px_spp")],
                         indirect=["world"])
def test_sharded_frame_fn_accumulates(world, key):
    """px-only: bit-equal to the unsharded accumulation; px x spp within
    JAX's atol 1e-5."""
    want = _unsharded_accum(_cfg(), BASE["num_frames"])
    for rank in world:
        if key == "frame_fn_px":
            assert torch.equal(rank[key], want)
        else:
            np.testing.assert_allclose(rank[key].numpy(), want.numpy(),
                                       atol=1e-5)


@pytest.mark.parametrize("world,key", [("world2", "multi_px"),
                                       ("world4", "multi_px_spp")],
                         indirect=["world"])
def test_sharded_multi_frame_fn_matches_per_frame(world, key):
    """K = 4 frames a call against 4 per-frame sharded steps (the JAX
    test's atol 1e-6; the same steps in the same order give the same
    bits)."""
    want = _unsharded_accum(_cfg(), 4)
    for rank in world:
        np.testing.assert_allclose(rank[key].numpy(), want.numpy(),
                                   atol=1e-6 if key == "multi_px" else 1e-5)
    if key == "multi_px":
        assert all(torch.equal(rank[key], want) for rank in world)


@pytest.mark.parametrize("world", ["world2", "world4"], indirect=True)
def test_validation_errors(world):
    for rank in world:
        e = rank["errors"]
        assert "not divisible" in e["height"], e
        assert "counter" in e["wang"], e
        assert "spp" in e["spp"] and "not divisible" in e["spp"], e
        assert "counter" in e["diff_wang"], e


@pytest.mark.parametrize("world,key", [("world2", "driver_px"),
                                       ("world4", "driver_px"),
                                       ("world4", "driver_px_spp")],
                         indirect=["world"])
def test_sharded_driver_matches_unsharded(world, key):
    cfg = _cfg(num_frames=2)
    r = OfflineRenderer(cfg, silent=True)
    r.run()
    for rank in world:
        if key == "driver_px":
            assert torch.equal(rank[key], r.accum)
        else:
            np.testing.assert_allclose(rank[key].numpy(), r.accum.numpy(),
                                       atol=1e-5)


def _train_results():
    return [(w, shape) for w, shapes in (("world2", TRAIN_MESHES[2]),
                                         ("world4", TRAIN_MESHES[4]))
            for shape in shapes]


@pytest.mark.parametrize("world,shape", _train_results(), indirect=["world"])
def test_training_step_matches_jax(world, shape, problem):
    """Every rank's loss and gradients against JAX's unsharded
    value_and_grad, with the tolerances of the JAX two-process test."""
    want_loss, want_grads = problem[2], problem[3]
    for rank in world:
        got = rank[("train", shape)]
        loss = float(got["loss"])
        assert abs(loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
        assert set(got["grads"]) == set(want_grads)
        for key, g in want_grads.items():
            mine = got["grads"][key].double().numpy()
            tol = 1e-4 * max(np.linalg.norm(g), 1e-6)
            assert abs(np.linalg.norm(mine) - np.linalg.norm(g)) <= tol, key
            assert abs(mine.sum() - g.sum()) <= 10 * tol, key


@pytest.mark.parametrize("world,shape", _train_results(), indirect=["world"])
def test_training_step_matches_unsharded_port(world, shape, problem):
    """The same step unsharded in the port: the loss within 1e-6 relative,
    each gradient within 1e-5 of its norm (the sums are taken in another
    order)."""
    params, target = problem[:2]
    scene, cam = scene_by_name("cornell_box")
    loss, grads = loss_and_grad(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(target), scene, cam, _train_texture(), _cfg(**TRAIN),
        FRAME)
    assert grads["albedo"].abs().max() > 0 and grads["env_rgb"].abs().max() > 0
    for rank in world:
        got = rank[("train", shape)]
        assert abs(float(got["loss"]) - float(loss)) <= 1e-6 * float(loss)
        for key, g in grads.items():
            torch.testing.assert_close(got["grads"][key], g, rtol=0,
                                       atol=1e-5 * max(g.norm().item(), 1e-12))


def test_training_step_bit_equal_twice(world2):
    for rank in world2:
        got = rank[("train", (2, 1))]
        loss, grads = got["again"]
        assert torch.equal(loss, got["loss"])
        for key, g in grads.items():
            assert torch.equal(g, got["grads"][key]), key


@pytest.mark.parametrize("world,shape", _train_results(), indirect=["world"])
def test_comm_elements_match_budget(world, shape, problem):
    """The f32 elements the step's collectives moved (counted in
    parallel/shard.py) equal the budget model."""
    cfg = _cfg(**TRAIN)
    want = budget.training_step_comm_elements(
        cfg.height, cfg.width, *shape, [v.size for v in problem[0].values()])
    for rank in world:
        assert rank[("train", shape)]["elements"] == want
    assert budget.training_step_comm_bytes(
        cfg.height, cfg.width, *shape,
        [v.size for v in problem[0].values()]) == 4 * want


def test_scaling_harness_runs():
    scene, cam = scene_by_name("cornell_box")
    pts = measure_scaling(scene, cam, None, _cfg(), device_counts=[1, 2],
                          frames=2, timeout=300)
    assert [p.devices for p in pts] == [1, 2]
    assert all(p.ms_per_frame > 0 and np.isfinite(p.mrays_per_s) for p in pts)
    assert pts[0].efficiency == 1.0
    assert pts[1].efficiency == pytest.approx(
        pts[0].ms_per_frame / pts[1].ms_per_frame / 2)


def test_debug_vis_shapes_and_jax():
    from cpuperformanceraytracer_tpu.utils import debug_vis as jvis

    from cpuperformanceraytracer_tpu_torch.utils.debug_vis import (
        CHUNK,
        block_ownership_image,
        overlay,
        shard_ownership_image,
    )

    cfg = _cfg(width=64, height=48)
    s = shard_ownership_image(cfg, 4)
    assert s.shape == (48, 64, 3)
    assert len(np.unique(s.reshape(-1, 3), axis=0)) == 4
    jcfg = _jax_cfg(width=64, height=48, tile_height=8, tile_width=64)
    np.testing.assert_array_equal(s, jvis.shard_ownership_image(jcfg, 4))
    rs = np.random.RandomState(0)
    render = rs.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    o = overlay(render, s)
    assert o.shape == (48, 64, 3) and o.max() > 0
    np.testing.assert_array_equal(o, jvis.overlay(render, s))
    for w in (64, 45):
        b = block_ownership_image(_cfg(width=w, height=48))
        assert b.shape == (48, w, 3)
        flat = b.reshape(-1, 3)
        # one colour a chunk of 32 pixels, and neighbouring chunks differ
        chunks = flat[: len(flat) // CHUNK * CHUNK].reshape(-1, CHUNK, 3)
        assert (chunks == chunks[:, :1]).all()
        assert (chunks[1:, 0] != chunks[:-1, 0]).any(-1).all()


def test_throughput_report():
    from cpuperformanceraytracer_tpu.utils.profiling import (
        throughput_report as jreport,
    )

    from cpuperformanceraytracer_tpu_torch.utils.profiling import (
        throughput_report,
    )

    kw = dict(width=1280, height=720, spp=1, bounces=8)
    r = throughput_report(_cfg(**kw), 100.0)
    assert abs(r.primary_mrays_per_s - 9.216) < 0.01
    assert abs(r.max_segment_mrays_per_s - 9.216 * 9) < 0.1
    assert "ms/frame" in str(r)
    j = jreport(_jax_cfg(**kw), 100.0)
    assert str(r) == str(j) and r.accum_bytes_per_frame == j.accum_bytes_per_frame


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    from cpuperformanceraytracer_tpu_torch.utils.profiling import TRACE_FILE, trace

    cfg = _cfg(width=8, height=4, bounces=1)
    with trace(str(tmp_path / "t")) as d:
        _unsharded(cfg)
    events = json.loads((tmp_path / "t" / TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert d == str(tmp_path / "t") and any("aten::" in str(n) for n in names)
