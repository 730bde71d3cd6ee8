"""Kernel B (deferred env resolve + accumulate): the port's plain version
vs the JAX ops it replaces on the main path (``env_texel_flat_index`` +
``_gather`` + ``rgb + env*miss_thr`` + ``accumulate_frame``), on
numpy-seeded synthetic planes. No interpret-mode call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets torch threads)
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3 as JVec3
from cpuperformanceraytracer_tpu.render.frame import accumulate_frame
from cpuperformanceraytracer_tpu.texture import texture as jtex
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
    env_accumulate,
    env_color_reference,
)
from cpuperformanceraytracer_tpu_torch.render.frame import frame_blend
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.texture.texture import (
    sample_environment_deferred,
    texture_from_array,
)

H, W = 32, 128
FRAME = 3


def _planes(seed=0):
    """Unit miss directions, jitter in [0,1), throughputs, rgb, missed."""
    rs = np.random.RandomState(seed)
    p = np.zeros((12, H, W), np.float32)
    d = rs.randn(3, H, W)
    p[3:6] = d / np.linalg.norm(d, axis=0)
    p[0:3] = rs.rand(3, H, W) * 2.0
    p[6:9] = rs.rand(3, H, W) * 1.5
    p[9:11] = rs.rand(2, H, W)
    p[11] = rs.rand(H, W) < 0.6
    p[6:9] *= p[11]  # a never-missed pixel carries zero miss throughput
    accum = (rs.rand(3, H, W) * 3.0).astype(np.float32)
    return p, accum


def _jax_resolve(p, accum, sky, kw):
    tex = jtex.texture_from_array(sky)
    cfg = JaxConfig(**kw)
    idx = jtex.env_texel_flat_index(tex, JVec3(*(jnp.asarray(c) for c in p[3:6])),
                                    cfg, jnp.asarray(p[9]), jnp.asarray(p[10]))
    env = jtex._gather(tex, idx)
    color = JVec3(*(jnp.asarray(p[c]) + e * jnp.asarray(p[6 + c])
                    for c, e in enumerate(env)))
    out = accumulate_frame(JVec3(*(jnp.asarray(a) for a in accum)), color,
                           FRAME)
    flat = np.clip(np.asarray(idx), 0, sky.shape[0] * sky.shape[1] - 1)
    return flat, np.stack([np.asarray(c) for c in out])


@pytest.mark.parametrize("sampling", ["stochastic", "nearest"])
def test_plain_matches_jax(sampling):
    sky = gradient_sky(64, 32, seed=3)
    p, accum = _planes()
    kw = dict(width=W, height=H, env_mode="equirect", env_sampling=sampling)
    want_idx, want = _jax_resolve(p, accum, sky, kw)

    got = torch.as_tensor(accum.copy())
    idx = torch.empty((H, W), dtype=torch.int64)
    out = env_accumulate(torch.as_tensor(p), texture_from_array(sky),
                         RenderConfig(**kw), got, frame_blend(FRAME),
                         index_out=idx)
    assert out is got  # updated in place
    same = idx.numpy() == want_idx
    # atan2/asin may differ by an ulp across libraries: a texel boundary
    # can move for a rare direction
    assert same.mean() >= 0.999
    for c in range(3):
        np.testing.assert_allclose(got.numpy()[c][same], want[c][same],
                                   rtol=1e-5)


def test_env_none():
    p, _ = _planes(seed=1)
    planes = torch.as_tensor(p)
    none = RenderConfig(width=W, height=H, env_mode="none")
    acc = torch.ones((3, H, W))
    env_accumulate(planes, None, none, acc, 0.25)
    torch.testing.assert_close(acc, 1.0 + (planes[:3] - 1.0) * 0.25)


def test_frame_zero_stores_color_exactly():
    sky = gradient_sky(32, 16, seed=5)
    p, _ = _planes(seed=2)
    cfg = RenderConfig(width=W, height=H)
    tex = texture_from_array(sky)
    a = env_accumulate(torch.as_tensor(p), tex, cfg,
                       torch.zeros((3, H, W)), frame_blend(0))
    color, _ = env_color_reference(torch.as_tensor(p), tex, cfg)
    assert frame_blend(0) == 1.0 and torch.equal(a, color)


def test_sample_environment_deferred_matches_jax():
    sky = gradient_sky(64, 32, seed=7)
    p, _ = _planes(seed=3)
    kw = dict(width=W, height=H)
    got = sample_environment_deferred(
        texture_from_array(sky), Vec3(*(torch.as_tensor(c) for c in p[3:6])),
        RenderConfig(**kw), torch.as_tensor(p[9]), torch.as_tensor(p[10]))
    want = jtex.sample_environment_deferred(
        jtex.texture_from_array(sky), JVec3(*(jnp.asarray(c) for c in p[3:6])),
        JaxConfig(**kw), jnp.asarray(p[9]), jnp.asarray(p[10]))
    for a, b in zip(got, want):
        assert np.mean(a.numpy() == np.asarray(b)) >= 0.999
