"""Checkpoint / resume across the two packages, on the CPU.

The port writes and reads the JAX package's ``.npz`` format: a JAX
checkpoint resumed by the port and a port checkpoint resumed by JAX both
restore the accumulator bit for bit and continue exactly as a renderer
handed that state in memory; a fingerprint mismatch starts fresh; a
resumed run on the port's plain path equals an uninterrupted one bit for
bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_cfg, port_cfg
from cpuperformanceraytracer_tpu.core.vecmath import Vec3 as JVec3
from cpuperformanceraytracer_tpu.io import checkpoint as jckpt
from cpuperformanceraytracer_tpu.render.driver import (
    OfflineRenderer as JaxRenderer,
)
from cpuperformanceraytracer_tpu.render.driver import RenderState
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.io import checkpoint as ckpt
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer

FRAMES = 2


@pytest.fixture(scope="module")
def jcfg():
    return jax_cfg(width=32, height=8, bounces=1, scene="cornell_box",
                   env_mode="none", rng="counter", backend="xla",
                   num_frames=FRAMES, warmup_frames=0)


@pytest.fixture(scope="module")
def jax_renderer(jcfg):
    return JaxRenderer(jcfg, silent=True)


def _port(jcfg, **kw):
    return OfflineRenderer(port_cfg(jcfg, **kw), silent=True)


def _np(v3):
    return np.stack([np.asarray(c) for c in v3])


def test_fingerprints_and_config_mapping(jcfg):
    pcfg = port_cfg(jcfg)
    assert ckpt.image_fingerprint(pcfg) == jckpt.image_fingerprint(jcfg)
    assert jckpt.image_fingerprint(pcfg) == ckpt.image_fingerprint(jcfg)
    mapped = RenderConfig.from_dict(dataclasses.asdict(jcfg))
    assert mapped == pcfg.replace(backend="cuda")   # "xla" is dropped
    assert RenderConfig.from_dict(dataclasses.asdict(pcfg)) == pcfg


def test_jax_checkpoint_resumed_by_port(jcfg, jax_renderer, tmp_path):
    path = str(tmp_path / "jax.npz")
    jr = jax_renderer
    jr.resume(None)                 # a fresh start
    jr.run(checkpoint_path=path, checkpoint_every=FRAMES)
    saved = _np(jr.state.accum)

    r = _port(jcfg)
    r.resume(path)
    assert r.frame == FRAMES
    np.testing.assert_array_equal(r.accum.numpy(), saved)
    twin = _port(jcfg)
    twin.accum, twin.frame = torch.as_tensor(saved.copy()), FRAMES
    r.step()
    twin.step()
    assert torch.equal(r.accum, twin.accum)
    jr.step()                      # JAX's own next frame, strict (cornell)
    np.testing.assert_allclose(r.accum.numpy(), _np(jr.state.accum),
                               rtol=1e-4, atol=1e-5)


def test_port_checkpoint_resumed_by_jax(jcfg, jax_renderer, tmp_path):
    path = str(tmp_path / "port.npz")
    r = _port(jcfg)
    r.run(checkpoint_path=path, checkpoint_every=FRAMES)
    saved = r.accum.numpy().copy()

    jr = jax_renderer
    jr.resume(path)
    assert jr.state.frame == FRAMES
    np.testing.assert_array_equal(_np(jr.state.accum), saved)
    jr.step()
    resumed = _np(jr.state.accum)
    jr.state = RenderState(accum=JVec3(*(jnp.asarray(c) for c in saved)),
                           frame=FRAMES)
    jr.step()
    np.testing.assert_array_equal(resumed, _np(jr.state.accum))
    r.step()
    np.testing.assert_allclose(r.accum.numpy(), resumed, rtol=1e-4,
                               atol=1e-5)


def test_fingerprint_mismatch_starts_fresh(jcfg, tmp_path):
    path = str(tmp_path / "c.npz")
    r = _port(jcfg)
    r.run(checkpoint_path=path, checkpoint_every=1)
    other = _port(jcfg, spp=2)
    other.resume(path)
    assert other.frame == 0 and not other.accum.any()
    accum, frame = jckpt.resume_or_fresh(path, jcfg.replace(bounces=2))
    assert frame == 0 and not np.asarray(accum.x).any()
    missing = _port(jcfg)
    missing.resume(str(tmp_path / "absent.npz"))
    assert missing.frame == 0


def test_resumed_run_equals_uninterrupted(tmp_path):
    """4 frames saved every 2, resumed in a new renderer for 2 more:
    bit-equal to 6 frames in one run (bilinear env, spp 2: the A -> E ->
    F route)."""
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import (
        texture_from_array,
    )

    tex = texture_from_array(gradient_sky(32, 16))
    cfg = RenderConfig(width=32, height=8, bounces=1, spp=2, rng="counter",
                       env_sampling="bilinear", backend="torch",
                       warmup_frames=1, num_frames=4)
    path = str(tmp_path / "r.npz")
    a = OfflineRenderer(cfg, texture=tex, silent=True)
    a.run(checkpoint_path=path, checkpoint_every=2)
    b = OfflineRenderer(cfg.replace(num_frames=2), texture=tex, silent=True)
    b.resume(path)
    assert b.frame == 4
    b.run()
    whole = OfflineRenderer(cfg.replace(num_frames=6), texture=tex,
                            silent=True)
    whole.run()
    assert b.frame == whole.frame == 6
    assert torch.equal(b.accum, whole.accum)
