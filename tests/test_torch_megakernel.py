"""Kernel A (the forward megakernel): the port's plain version vs the JAX
``_pallas_render`` in interpret mode, on the identical scene.

Interpret mode is slow on the CPU (seconds per call), so each JAX
reference is computed once per module. Strict tolerances (rtol 1e-4,
atol 1e-5 on all 12 planes) hold for the diffuse cornell box, whose
paths are decision-stable; the glass scene with an env map is held to
robust statistics, because a 1-ulp transcendental difference can flip a
lottery roll (tests/test_pallas.py policy).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_robust, jax_cfg, port_cfg, port_scene
from cpuperformanceraytracer_tpu.kernels.megakernel import _pallas_render
from cpuperformanceraytracer_tpu.scene.presets import (
    cornell_box_scene,
    glass_spheres_scene,
)
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    N_PLANES,
    PLANE_NAMES,
    pack_tables,
    plane_mismatch,
    render_planes,
    render_planes_reference,
)

PLANES = PLANE_NAMES
CORNELL = dict(scene="cornell_box", bounces=2, env_mode="none", jitter=True,
               ambient=(0.1, 0.1, 0.1), env_flip_xz=False, roulette="off")
GLASS = dict(scene="glass_spheres", bounces=3, jitter=True,
             env_mode="equirect", env_sampling="stochastic")


def _case(jscene, jcam, jtex, frame, **kw):
    jcfg = jax_cfg(**kw)
    want = np.stack([np.asarray(p) for p in
                     _pallas_render(jscene, jcam, jtex, jcfg, frame)])
    scene, cam = port_scene(jscene, jcam)
    cfg = port_cfg(jcfg)
    return cfg, pack_tables(scene, cam, cfg, "cpu"), want


@pytest.fixture(scope="module")
def cornell_wang():
    return _case(*cornell_box_scene(), None, 2, rng="wang", spp=2, **CORNELL)


@pytest.fixture(scope="module")
def cornell_counter():
    return _case(*cornell_box_scene(), None, 1, rng="counter", spp=2,
                 **CORNELL)


@pytest.fixture(scope="module")
def glass_env():
    tex = texture_from_array(gradient_sky(64, 32))
    return _case(*glass_spheres_scene(), tex, 1, rng="wang", **GLASS)


def _strict(case, frame):
    cfg, tables, want = case
    got = render_planes(tables, cfg, frame).numpy()
    assert got.shape == (N_PLANES, cfg.height, cfg.width)
    for i, name in enumerate(PLANES):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    return got


def test_cornell_wang_strict(cornell_wang):
    got = _strict(cornell_wang, 2)
    assert got[0].mean() > 0.0


def test_cornell_counter_strict(cornell_counter):
    _strict(cornell_counter, 1)


def test_glass_env_robust(glass_env):
    cfg, tables, want = glass_env
    got = render_planes(tables, cfg, 1).numpy()
    for i in (0, 1, 2, 6, 7, 8):
        assert_robust(got[i], want[i], what=PLANES[i])
    # every plane, the deferred miss state included (which pixels escaped,
    # their direction, throughput and env jitter): under 0.1% of pixels
    # off by > 1e-3 (0 of 2048 measured on the CPU)
    off = plane_mismatch(torch.from_numpy(got), torch.from_numpy(want))
    assert max(off.values()) < 1e-3, off
    assert 0.0 < got[11].mean() < 1.0


@pytest.mark.parametrize("a,b", [("jr", "jc"), ("md_x", "md_z")])
def test_plane_mismatch_sees_swapped_miss_state(glass_env, a, b):
    # a kernel that stored the miss state in the wrong planes must fail
    cfg, tables, want = glass_env
    got = torch.from_numpy(want.copy())
    ia, ib = PLANE_NAMES.index(a), PLANE_NAMES.index(b)
    got[[ia, ib]] = got[[ib, ia]]
    off = plane_mismatch(got, torch.from_numpy(want))
    assert off[a] > 0.5 and off[b] > 0.5, off
    assert off["r"] == off["missed"] == 0.0


def test_wrapper_takes_plain_version_on_cpu(glass_env):
    cfg, tables, _ = glass_env
    before = render_planes.launches
    a = render_planes(tables, cfg, 4)
    b = render_planes_reference(tables, cfg, 4)
    assert torch.equal(a, b)
    assert render_planes.launches == before  # the CPU path launches nothing


def test_wrapper_rejects_other_devices(glass_env):
    cfg, tables, _ = glass_env
    meta = tuple(t.to("meta") for t in tables)
    with pytest.raises(ValueError, match="unsupported device"):
        render_planes(meta, cfg, 0)
