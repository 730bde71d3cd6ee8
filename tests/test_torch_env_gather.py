"""Kernel E's plain version (the deferred env lookup and the texel fetch)
against the JAX package, on the CPU.

- ``env_lookup_reference`` / ``sample_environment_deferred`` vs JAX
  ``sample_environment_deferred`` for all six env_mode x env_sampling
  pairs on the same miss directions and jitter, with exact cube
  diagonals (the face ties), axis directions, a cube edge where u = 1
  (the stochastic tap's flat wrap into the next row) and the top row
  (an index past the end, clamped);
- ``gather_texels`` vs JAX ``gather_texels_mxu`` in interpret mode (rtol
  2e-5, its bf16 hi/lo error, as tests/test_pallas.py) and vs exact
  numpy indexing;
- the tap indices, the wrapper's CPU dispatch and its ``out`` slot;
- ``bilinear_resample`` vs the JAX one.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one torch thread per worker)
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3 as JVec3
from cpuperformanceraytracer_tpu.kernels.env_gather import gather_texels_mxu
from cpuperformanceraytracer_tpu.texture import texture as jtexture
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.io.convert import texture_from
from cpuperformanceraytracer_tpu_torch.kernels.env_gather import (
    env_lookup,
    env_lookup_reference,
    gather_texels,
)
from cpuperformanceraytracer_tpu_torch.texture import texture as ttexture

PAIRS = list(itertools.product(["equirect", "cubemap"],
                               ["stochastic", "nearest", "bilinear"]))
JMAX = np.float32(1.0) - np.float32(2.0 ** -24)   # the largest draw < 1


def _directions(n_random=2000, seed=0):
    """(N, 3) f32 unit directions and (N,) jitter pairs: random ones plus
    the cube's diagonals and axes, a cube edge (u = 1 on the +z face)
    and straight up, with jitter next to 1 on the special ones."""
    rs = np.random.RandomState(seed)
    d = rs.normal(size=(n_random, 3))
    special = [s * np.array(v, np.float64) for v in (
        (1, 1, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 0, 0), (0, 1, 0),
        (0, 0, 1), (1, -1, 1), (-1, 1, -1), (1e-3, 1, 1e-3))
        for s in (1, -1)]
    d = np.concatenate([d, np.array(special)])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    for i in range(n_random, len(d)):   # exact ties: equal magnitudes
        m = np.abs(d[i]).max()
        d[i] = np.where(np.abs(d[i]) > 0.99 * m, np.sign(d[i]) * m, d[i])
    jr = rs.rand(len(d)).astype(np.float32)
    jc = rs.rand(len(d)).astype(np.float32)
    jr[n_random:] = JMAX
    jc[n_random:] = JMAX
    return d, jr, jc


@pytest.fixture(scope="module")
def textures():
    eq = jtexture.texture_from_array(gradient_sky(64, 32, seed=1))
    cube = jtexture.texture_from_array(np.concatenate(
        [gradient_sky(16, 16, seed=i) for i in range(6)]))
    return {"equirect": eq, "cubemap": cube}


@pytest.mark.parametrize("env_mode,sampling", PAIRS)
def test_lookup_matches_jax(textures, env_mode, sampling):
    d, jr, jc = _directions()
    jtex = textures[env_mode]
    jcfg = JaxConfig(env_mode=env_mode, env_sampling=sampling)
    want = jtexture.sample_environment_deferred(
        jtex, JVec3(*(jnp.asarray(d[:, i]) for i in range(3))), jcfg,
        jnp.asarray(jr), jnp.asarray(jc))
    want = np.stack([np.asarray(c) for c in want], -1)

    cfg = RenderConfig(env_mode=env_mode, env_sampling=sampling,
                       backend="torch")
    tex = texture_from(jtex)
    got = ttexture.sample_environment_deferred(
        tex, Vec3(*(torch.as_tensor(d[:, i]) for i in range(3))), cfg,
        torch.as_tensor(jr), torch.as_tensor(jc))
    got = torch.stack(list(got), -1).numpy()
    # atan2/asin come from two libraries (XLA, torch): a 1-ulp uv may
    # move one tap, so equirect holds the colours on all but 1% of the
    # directions; the cubemap's uv is exact arithmetic
    close = np.isclose(got, want, rtol=1e-6, atol=1e-6).all(-1)
    if env_mode == "cubemap":
        assert close.all(), np.flatnonzero(~close)[:10]
    else:
        assert close.mean() > 0.99
        assert close[-20:].all()


def test_cubemap_ties_and_flat_wrap(textures):
    """The exact diagonals pick Z over Y over X; u = 1 on a cube edge
    with jitter next to 1 wraps the stochastic tap into the next row,
    and the nearest tap clamps its column instead."""
    tex = texture_from(textures["cubemap"])
    w = tex.width
    diag = Vec3(*(torch.tensor([v], dtype=torch.float32)
                  for v in (0.5, 0.5, 0.5)))
    u, v = ttexture.cubemap_uv(diag)
    ju, jv = jtexture.cubemap_uv(JVec3(*(jnp.float32(0.5),) * 3))
    assert (u.item(), v.item()) == (float(ju), float(jv))
    assert 4.0 / 6.0 - 1e-6 <= v.item() <= 5.0 / 6.0 + 1e-6   # the +z face
    edge = Vec3(*(torch.tensor([c], dtype=torch.float32)
                  for c in (0.7071068, 0.0, 0.7071068)))
    u, v = ttexture.cubemap_uv(edge)
    assert u.item() == 1.0
    jr = jc = torch.tensor([float(JMAX)])
    stoch = RenderConfig(env_mode="cubemap", env_sampling="stochastic")
    idx = ttexture.env_texel_flat_index(tex, edge, stoch, jr, jc)
    row = int(np.floor(np.float32(v.item()) * np.float32(tex.height - 1)
                       + JMAX))
    assert idx.item() == (row + 1) * w              # wrapped: column W
    near = stoch.replace(env_sampling="nearest")
    assert ttexture.env_texel_flat_index(tex, edge, near, jr, jc).item() \
        % w == w - 1


def test_tap_indices_and_out_slot(textures):
    d, jr, jc = _directions(180, seed=2)   # 180 + 20 special
    tex = texture_from(textures["equirect"])
    h, w = 8, 25                    # 200 pixels as (12, H, W) planes
    planes = torch.zeros((12, h, w))
    for i in range(3):
        planes[3 + i] = torch.as_tensor(d[:, i]).reshape(h, w)
    planes[9] = torch.as_tensor(jr).reshape(h, w)
    planes[10] = torch.as_tensor(jc).reshape(h, w)
    for sampling in ("stochastic", "nearest", "bilinear"):
        cfg = RenderConfig(width=w, height=h, env_sampling=sampling,
                           backend="torch")
        taps = torch.empty((h * w, 4), dtype=torch.int64)
        slab = torch.zeros((2, h * w, 4))
        got = env_lookup(planes, tex, cfg, out=slab[1], taps_out=taps)
        assert got.data_ptr() == slab[1].data_ptr()
        torch.testing.assert_close(got, env_lookup_reference(planes, tex, cfg))
        assert (got[:, 3] == 0).all() and (slab[0] == 0).all()
        assert ((taps >= 0) & (taps < tex.width * tex.height)).all()
        if sampling != "bilinear":
            assert (taps == taps[:, :1]).all()
            flat = tex.r[taps[:, 0]]
            torch.testing.assert_close(got[:, 0], flat, rtol=0, atol=0)
        else:                      # the 2x2 neighbourhood of one texel
            r, c = taps // tex.width, taps % tex.width
            assert (r[:, 0] == r[:, 1]).all() and (c[:, 0] == c[:, 2]).all()
            assert ((r[:, 2] - r[:, 0]) <= 1).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_gather_texels_matches_mxu_and_numpy(dtype):
    jtex = jtexture.texture_from_array(gradient_sky(64, 32, seed=3))
    rs = np.random.RandomState(1)
    rows = rs.randint(0, jtex.height, (2048,)).astype(dtype)
    cols = rs.randint(0, jtex.width, (2048,)).astype(dtype)
    got = gather_texels(texture_from(jtex), torch.as_tensor(rows),
                        torch.as_tensor(cols)).numpy()
    flat = rows.astype(np.int64) * jtex.width + cols
    for c, plane in enumerate((jtex.r, jtex.g, jtex.b)):
        np.testing.assert_array_equal(got[:, c], np.asarray(plane)[flat])
    assert (got[:, 3] == 0).all()
    mxu = gather_texels_mxu(jtex, jnp.asarray(rows, jnp.int32),
                            jnp.asarray(cols, jnp.int32))
    for c, plane in enumerate(mxu):
        np.testing.assert_allclose(got[:, c], np.asarray(plane), rtol=2e-5,
                                   atol=1e-6)


def test_gather_texels_clamps_each_axis():
    tex = ttexture.texture_from_array(gradient_sky(16, 8, seed=4))
    rows = torch.tensor([-3, 0, 7, 20])
    cols = torch.tensor([5, -1, 40, 15])
    got = gather_texels(tex, rows, cols)
    want = tex.r[torch.tensor([0 * 16 + 5, 0, 7 * 16 + 15, 7 * 16 + 15])]
    assert torch.equal(got[:, 0], want)


@pytest.mark.parametrize("out_w,out_h", [(2, 2), (7, 3), (33, 17), (5, 40)])
def test_bilinear_resample_matches_jax(out_w, out_h):
    """The port's pixel-center resample equals the JAX package's on an
    8x12 image, down, up and across the aspect."""
    img = np.random.RandomState(out_w).rand(8, 12, 3).astype(np.float32)
    got = ttexture.bilinear_resample(img, out_w, out_h)
    want = jtexture.bilinear_resample(img, out_w, out_h)
    assert got.shape == (out_h, out_w, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
