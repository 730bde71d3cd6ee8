"""Gradients through the port's oracle integrator, plain and with path
replay (``diff/path_replay.py``), against the JAX package's oracle
gradients.

- replay vs plain autograd through the oracle: the cornell box of
  ``tests/test_diff.py::TestPathReplay`` (spp 2, 2 bounces, counter RNG)
  and the Beer scene with a bilinear env; JAX's rtol 1e-4 and atol 1e-7;
- the port's oracle gradients vs JAX's ``loss_and_grad`` through its XLA
  oracle on the Beer scene (every path refracts, so no lottery decision
  can flip) with a bilinear env, which the kernel routes refuse: each
  key's reference asserted nonzero first, then rtol 2e-3 and atol 2e-3
  of the key's largest reference gradient (the JAX diff tests'
  tolerance; the bilinear weights carry an ulp of the uv, see
  ``tests/test_torch_integrator.py``);
- that replay keeps no bounce intermediates: the bytes autograd saves
  for the backward outside the checkpointed segments, counted with
  ``torch.autograd.graph.saved_tensors_hooks`` (each segment's input
  carry, which the checkpoint keeps, is not among them; the device's
  peak memory of both is measured by ``chip_smoke.py`` on the card).

The JAX reference (about 15 s on a CPU) runs once, in a module fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import beer_scene, port_cfg, port_scene
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.diff import grad as jgrad
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu.scene.camera import make_camera
from cpuperformanceraytracer_tpu.scene.presets import cornell_box_scene
from cpuperformanceraytracer_tpu.scene.types import Material
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    image_loss,
    loss_and_grad,
    render_for_params,
    value_and_grad,
)
from cpuperformanceraytracer_tpu_torch.diff.path_replay import (
    render_for_params_replay,
)
from cpuperformanceraytracer_tpu_torch.io.convert import texture_from

FRAME = 1
CORNELL = dict(width=32, height=24, spp=2, bounces=2, scene="cornell_box",
               env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
               jitter=True, roulette="off", rng="counter", backend="xla")
BEER = dict(width=64, height=16, bounces=3, rng="counter", jitter=True,
            roulette="off", env_mode="equirect", env_sampling="bilinear",
            backend="xla")


def _np_params(jscene, jtex=None):
    m, s = jscene.materials.albedo, jscene.spheres.center
    p = {"albedo": np.stack([np.asarray(c) for c in (m.x, m.y, m.z)], -1)
         + np.float32(0.1),
         "sphere_centers": np.stack([np.asarray(c) for c in (s.x, s.y, s.z)],
                                    -1) + np.float32(0.1),
         "sphere_radii": np.asarray(jscene.spheres.radius) + np.float32(0.05)}
    if jtex is not None:
        p["env_rgb"] = np.stack([np.asarray(c) for c in (jtex.r, jtex.g,
                                                         jtex.b)], -1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _port_problem(jscene, jcam, jtex, jcfg):
    scene, cam = port_scene(jscene, jcam)
    tex = None if jtex is None else texture_from(jtex)
    cfg = port_cfg(jcfg, backend="oracle")
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    return scene, cam, tex, cfg, target


def _beer():
    jscene, jcam = beer_scene(SceneBuilder, Material, make_camera)
    return jscene, jcam, texture_from_array(gradient_sky(64, 32))


@pytest.fixture(scope="module")
def beer_oracle_grads():
    """(port loss, port grads, JAX loss, JAX grads) through both oracles,
    against each side's target at frame 0."""
    jscene, jcam, jtex = _beer()
    jcfg = JaxConfig(**BEER)
    params = _np_params(jscene, jtex)
    jtarget = jgrad.render_for_params({}, jscene, jcam, jtex, jcfg, 0)
    lx, gx = jgrad.loss_and_grad({k: jnp.asarray(v) for k, v in params.items()},
                                 jtarget, jscene, jcam, jtex, jcfg, FRAME)
    scene, cam, tex, cfg, target = _port_problem(jscene, jcam, jtex, jcfg)
    lt, gt = loss_and_grad({k: torch.from_numpy(v) for k, v in params.items()},
                           target, scene, cam, tex, cfg, FRAME)
    return (float(lt), {k: v.numpy() for k, v in gt.items()}, float(lx),
            {k: np.asarray(v) for k, v in gx.items()})


@pytest.mark.parametrize("key", ["albedo", "sphere_centers", "sphere_radii",
                                 "env_rgb"])
def test_oracle_grads_match_jax_bilinear(beer_oracle_grads, key):
    lt, gt, lx, gx = beer_oracle_grads
    np.testing.assert_allclose(lt, lx, rtol=1e-4)
    a, b = gx[key], gt[key]
    assert np.abs(a).max() > 0.0, f"{key}: the reference is all zero"
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-3 * np.abs(a).max(),
                               err_msg=key)


def _replay_vs_plain(jscene, jcam, jtex, jcfg):
    scene, cam, tex, cfg, target = _port_problem(jscene, jcam, jtex, jcfg)
    params = {k: torch.from_numpy(v)
              for k, v in _np_params(jscene, jtex).items()}

    def loss(render):
        return lambda p: image_loss(render(p, scene, cam, tex, cfg, FRAME),
                                    target)

    saved = []

    def pack(t):
        saved[-1] += t.numel() * t.element_size()
        return t

    out = []
    for render in (render_for_params, render_for_params_replay):
        saved.append(0)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out.append(value_and_grad(loss(render), params))
    return out, saved


@pytest.mark.parametrize("case", ["cornell", "beer_bilinear"])
def test_replay_grads_equal_plain(case):
    """Path replay regenerates each segment's draws from the carry: the
    same loss and gradients as plain autograd through the oracle (JAX's
    TestPathReplay tolerance), and under half the bytes saved outside
    the checkpointed segments."""
    if case == "cornell":
        jscene, jcam = cornell_box_scene()
        jtex, jcfg = None, JaxConfig(**CORNELL)
    else:
        jscene, jcam, jtex = _beer()
        jcfg = JaxConfig(**BEER)
    ((lp, gp), (lr, gr)), (plain_bytes, replay_bytes) = _replay_vs_plain(
        jscene, jcam, jtex, jcfg)
    torch.testing.assert_close(lr, lp, rtol=1e-4, atol=1e-7)
    assert gp["albedo"].abs().max() > 0.0
    for k in gp:
        torch.testing.assert_close(gr[k], gp[k], rtol=1e-4, atol=1e-7)
    assert replay_bytes < plain_bytes / 2, (replay_bytes, plain_bytes)
