"""Row windows of kernels A and C (the sharding hooks of
``parallel/shard.py``): the plain versions on a window of pixel rows
against the JAX package's kernels on the same window (interpret mode, as
``tests/test_pallas.py`` and ``tests/test_diff_pallas.py`` run them), and
against the rows of their own whole image.

- kernel A: ``render_planes_reference(..., row0=, local_height=)`` vs the
  JAX ``_pallas_render(..., row0=, local_height=)`` (the kernel behind
  ``render_frame_pallas``), all 12 planes at rtol 1e-4, atol 1e-5 (the
  diffuse cornell box), and bit-equal to rows [row0, row0 + h) of the
  plain whole image, wang and counter;
- kernel C: ``bwd_tables_reference`` on the window vs the JAX
  ``_bwd_tables(..., row0=, local_h=)`` (the adjoint that
  ``_diff_sample_fn`` runs on its row0), rtol 2e-3 and atol 2e-3 of the
  largest cotangent (``tests/test_torch_backward.py``'s policy), and
  equal (rtol 1e-6) to the whole image's cotangents with the rows
  outside the window zeroed;
- the differentiable frame and the frame step on a window, and the
  windows that are refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_cfg, port_cfg, port_scene
from cpuperformanceraytracer_tpu.kernels.backward import (
    _bwd_tables,
    bake_base_tables,
)
from cpuperformanceraytracer_tpu.kernels.megakernel import (
    _pallas_render,
    pack_camera as jax_pack_camera,
    pack_scene as jax_pack_scene,
)
from cpuperformanceraytracer_tpu.scene.presets import cornell_box_scene
from cpuperformanceraytracer_tpu_torch.diff.grad import render_frame_plain
from cpuperformanceraytracer_tpu_torch.kernels.backward import (
    bwd_tables,
    bwd_tables_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    PLANE_NAMES,
    pack_tables,
    render_planes,
    render_planes_reference,
)
from cpuperformanceraytracer_tpu_torch.render.frame import make_frame_fn
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

FRAME = 1
ROW0, LOCAL_H = 8, 8      # the second of two 8-row blocks of 128x16
CORNELL = dict(scene="cornell_box", width=128, height=16, bounces=2,
               jitter=True, roulette="off", env_mode="none",
               ambient=(0.1, 0.1, 0.1), env_flip_xz=False)


def _port(jcfg):
    cfg = port_cfg(jcfg)
    scene, cam = port_scene(*cornell_box_scene())
    return cfg, pack_tables(scene, cam, cfg, "cpu")


@pytest.fixture(scope="module", params=["wang", "counter"])
def window_a(request):
    jcfg = jax_cfg(rng=request.param, spp=2, **CORNELL)
    want = _pallas_render(*cornell_box_scene(), None, jcfg, FRAME,
                          row0=ROW0, local_height=LOCAL_H)
    return (*_port(jcfg), np.stack([np.asarray(p) for p in want]))


@pytest.fixture(scope="module")
def window_c():
    jscene, jcam = cornell_box_scene()
    jcfg = jax_cfg(rng="counter", **CORNELL)
    jtables = (*jax_pack_scene(jscene), jax_pack_camera(jcam, jcfg))
    cot6 = np.random.RandomState(0).randn(6, LOCAL_H, 128).astype(np.float32)
    want = _bwd_tables(jcfg, *jtables, FRAME, 0,
                       tuple(jnp.asarray(c) for c in cot6), row0=ROW0,
                       local_h=LOCAL_H, trained=frozenset({"albedo", "emissive"}),
                       baked=bake_base_tables(jscene, jcam, jcfg))
    tables = tuple(torch.from_numpy(np.asarray(t, np.float32).copy())
                   for t in jtables)
    return port_cfg(jcfg), tables, torch.from_numpy(cot6), [
        np.asarray(w) for w in want]


def test_plain_a_window_matches_jax(window_a):
    cfg, tables, want = window_a
    got = render_planes(tables, cfg, FRAME, row0=ROW0,
                        local_height=LOCAL_H).numpy()
    assert got.shape == (12, LOCAL_H, cfg.width) and got[0].mean() > 0.0
    for i, name in enumerate(PLANE_NAMES):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("rng", ["wang", "counter"])
@pytest.mark.parametrize("width,height,row0,h", [(128, 16, 8, 8),
                                                 (128, 16, 3, 5),
                                                 (45, 7, 2, 4),
                                                 (32, 24, 0, 24)])
def test_plain_a_window_equals_rows_of_the_whole_image(rng, width, height,
                                                       row0, h):
    cfg = port_cfg(jax_cfg(rng=rng, spp=2, **CORNELL), width=width,
                   height=height)
    tables = pack_tables(*scene_by_name("cornell_box"), cfg, "cpu")
    full = render_planes_reference(tables, cfg, FRAME, sample0=1)
    got = render_planes_reference(tables, cfg, FRAME, sample0=1, row0=row0,
                                  local_height=h)
    assert torch.equal(got, full[:, row0:row0 + h])


def test_plain_c_window_matches_jax(window_c):
    cfg, tables, cot6, want = window_c
    got = bwd_tables(tables, cfg, FRAME, 0, cot6, row0=ROW0,
                     local_height=LOCAL_H)
    for i in (2, 3):  # the trained material rows and the camera
        scale = np.abs(want[i]).max()
        assert scale > 0.0
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=2e-3,
                                   atol=2e-3 * scale)


def test_plain_c_window_equals_the_whole_image_with_other_rows_zero(window_c):
    cfg, tables, cot6, _ = window_c
    got = bwd_tables_reference(tables, cfg, FRAME, 0, cot6, row0=ROW0,
                               local_height=LOCAL_H)
    whole = torch.zeros((6, cfg.height, cfg.width))
    whole[:, ROW0:ROW0 + LOCAL_H] = cot6
    want = bwd_tables_reference(tables, cfg, FRAME, 0, whole)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6,
                                   atol=1e-6 * w.abs().max().item())


def test_diff_frame_and_frame_step_on_a_window():
    """The differentiable plain frame and the frame step (A -> E -> F with
    a texture and spp 2) on a window: the rows of the whole image, and a
    sample offset moves the counter stream."""
    cfg = port_cfg(jax_cfg(rng="counter", spp=2, **CORNELL), height=12,
                   env_mode="equirect", env_sampling="bilinear")
    scene, cam = scene_by_name("cornell_box")
    tex = texture_from_array(gradient_sky(32, 16))
    zeros = torch.zeros((3, cfg.height, cfg.width))
    full = make_frame_fn(cfg, scene, cam, "cpu")(tex, FRAME, zeros, 1.0)
    step = make_frame_fn(cfg, scene, cam, "cpu", row0=4, local_height=6)
    got = step(tex, FRAME, torch.zeros((3, 6, cfg.width)), 1.0)
    assert torch.equal(got, full[:, 4:10])
    shifted = make_frame_fn(cfg, scene, cam, "cpu", spp_offset=2)(
        tex, FRAME, torch.zeros_like(zeros), 1.0)
    assert not torch.equal(shifted, full)
    dcfg = cfg.replace(env_sampling="stochastic")
    whole = render_frame_plain(scene, cam, tex, dcfg, FRAME)
    rows = render_frame_plain(scene, cam, tex, dcfg, FRAME, row0=4,
                              local_height=6)
    assert torch.equal(rows, whole[:, 4:10])


@pytest.mark.parametrize("row0,h", [(-1, 4), (10, 8), (0, 17)])
def test_windows_outside_the_image_are_refused(row0, h):
    cfg, tables = _port(jax_cfg(rng="counter", **CORNELL))
    with pytest.raises(ValueError, match="not inside"):
        render_planes(tables, cfg, FRAME, row0=row0, local_height=h)
    with pytest.raises(ValueError, match="not inside"):
        bwd_tables(tables, cfg, FRAME, 0, torch.zeros((6, 16, 128)),
                   row0=row0, local_height=h)
