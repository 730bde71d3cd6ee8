"""Port scene/ and texture/ vs the JAX package: kernel tables equal, the
numpy conversion round-trips the presets, and the deferred env texel
index agrees (including the u = 1 flat-index wrap)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets torch threads)
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3 as JVec3
from cpuperformanceraytracer_tpu.kernels import megakernel as jmk
from cpuperformanceraytracer_tpu.scene import presets as jpresets
from cpuperformanceraytracer_tpu.texture import texture as jtex
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.io.convert import (
    camera_from,
    scene_from,
    texture_from,
)
from cpuperformanceraytracer_tpu_torch.kernels import megakernel as tmk
from cpuperformanceraytracer_tpu_torch.texture import hdr as thdr
from cpuperformanceraytracer_tpu_torch.scene import presets as tpresets
from cpuperformanceraytracer_tpu_torch.texture import texture as ttex

SCENES = ["cornell_box", "glass_spheres"]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


@pytest.mark.parametrize("name", SCENES)
def test_pack_tables_equal_jax(name):
    js, jc = jpresets.scene_by_name(name)
    ts, tc = tpresets.scene_by_name(name)
    for got, want in zip(tmk.pack_scene(ts), jmk.pack_scene(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = JaxConfig()
    np.testing.assert_array_equal(tmk.pack_camera(tc, cfg).numpy(),
                                  np.asarray(jmk.pack_camera(jc, cfg)))


@pytest.mark.parametrize("name", SCENES)
def test_convert_round_trips_presets(name):
    js, jc = jpresets.scene_by_name(name)
    ts, tc = tpresets.scene_by_name(name)
    for got, want in zip(_leaves((scene_from(js), camera_from(jc))),
                         _leaves((ts, tc))):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_convert_takes_dicts_of_numpy():
    _, jc = jpresets.scene_by_name("glass_spheres")
    cam = {"position": {"x": 1.0, "y": 2.0, "z": 3.0},
           "distance": np.float32(jc.distance), "forward_z": -1.0}
    got = camera_from(cam)
    assert float(got.position.z) == 3.0 and float(got.forward_z) == -1.0


def test_grey_albedo_bug_flag():
    js, _ = jpresets.glass_spheres_scene(grey_albedo_bug=True)
    ts, _ = tpresets.glass_spheres_scene(grey_albedo_bug=True)
    got = tmk.pack_scene(ts)[2].numpy()
    np.testing.assert_array_equal(got, np.asarray(jmk.pack_scene(js)[2]))
    np.testing.assert_array_equal(got[:, 1], got[:, 0])


def test_texture_from_array_and_convert():
    sky = gradient_sky(32, 16, seed=5)
    t = ttex.texture_from_array(sky)
    j = jtex.texture_from_array(sky)
    assert (t.width, t.height) == (j.width, j.height) == (32, 16)
    for a, b in zip((t.r, t.g, t.b), (j.r, j.g, j.b)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    conv = texture_from(j)
    for a, b in zip(conv[:3], t[:3]):
        assert torch.equal(a, b)


def _dirs(n, seed):
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    jr, jc = (rs.rand(2, n).astype(np.float32))
    return d, jr, jc


@pytest.mark.parametrize("sampling", ["stochastic", "nearest"])
@pytest.mark.parametrize("flip", [True, False])
def test_env_texel_flat_index(sampling, flip):
    sky = gradient_sky(64, 32, seed=1)
    d, jr, jc = _dirs(20_000, seed=2)
    kw = dict(env_mode="equirect", env_sampling=sampling, env_flip_xz=flip)
    got = ttex.env_texel_flat_index(
        ttex.texture_from_array(sky), Vec3(*(torch.as_tensor(c) for c in d.T)),
        RenderConfig(**kw), torch.as_tensor(jr), torch.as_tensor(jc)).numpy()
    want = np.asarray(jtex.env_texel_flat_index(
        jtex.texture_from_array(sky), JVec3(*(jnp.asarray(c) for c in d.T)),
        JaxConfig(**kw), jnp.asarray(jr), jnp.asarray(jc)))
    # atan2/asin of two libraries may differ by an ulp, which can move a
    # direction across a texel boundary
    assert np.mean(got == want) >= 0.999


def test_equirect_uv_close():
    d, _, _ = _dirs(20_000, seed=3)
    u, v = ttex.equirect_uv(Vec3(*(torch.as_tensor(c) for c in d.T)))
    uv = jtex.equirect_uv(JVec3(*(jnp.asarray(c) for c in d.T)))
    np.testing.assert_allclose(u.numpy(), np.asarray(uv.x), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(uv.y), atol=1e-6)


def test_flat_index_wrap_and_clamp():
    """u = 1 with jitter 1 reaches column W: the FLAT index wraps into the
    next row's first texel (no column clamp); past the end it clamps."""
    sky = gradient_sky(16, 9, seed=4)
    t, j = ttex.texture_from_array(sky), jtex.texture_from_array(sky)
    u = np.array([1.0, 1.0, 0.0], np.float32)
    v = np.array([0.375, 1.0, 0.0], np.float32)   # rows 3, 8 and 0 of 9
    jr = np.array([0.0, 1.0, 0.0], np.float32)
    jc = np.array([1.0, 1.0, 0.0], np.float32)
    got = ttex.stochastic_flat_index(
        t, *(torch.as_tensor(a) for a in (u, v, jr, jc)))
    want = jtex.stochastic_flat_index(
        j, jtex.Vec2(jnp.asarray(u), jnp.asarray(v)), jnp.asarray(jr),
        jnp.asarray(jc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # row 3, column 16 -> row 4, column 0; row 9, column 16 -> past the end
    assert got.tolist() == [4 * 16, 9 * 16 + 16, 0]
    texels = ttex.gather_texels(t, got)
    for a, b in zip(texels, jtex._gather(j, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    flat = sky.reshape(-1, 3)
    np.testing.assert_array_equal(texels.x.numpy(),
                                  flat[[4 * 16, 9 * 16 - 1, 0], 0])


def test_hdr_codec_matches_jax(tmp_path):
    """The copied RGBE codec reads what the JAX package reads."""
    from cpuperformanceraytracer_tpu.texture import hdr as jhdr

    path = str(tmp_path / "sky.hdr")
    sky = gradient_sky(24, 12, seed=6)
    thdr.write_hdr(path, sky)
    got = ttex.load_texture(path)
    want = jtex.load_texture(path)
    assert (got.width, got.height) == (24, 12)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(thdr.read_hdr(path, flip_vertical=False),
                                  jhdr.read_hdr(path, flip_vertical=False))
