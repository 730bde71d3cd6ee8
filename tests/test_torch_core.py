"""Port core/ and config vs the JAX package: RNG bit-exact, vector math,
samplers and color transforms to rtol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets torch threads)
from cpuperformanceraytracer_tpu.core import color as jcolor
from cpuperformanceraytracer_tpu.core import rng as jrng
from cpuperformanceraytracer_tpu.core import sampling as jsampling
from cpuperformanceraytracer_tpu.core import vecmath as jvm
from cpuperformanceraytracer_tpu_torch.core import color as tcolor
from cpuperformanceraytracer_tpu_torch.core import rng as trng
from cpuperformanceraytracer_tpu_torch.core import sampling as tsampling
from cpuperformanceraytracer_tpu_torch.core import vecmath as tvm

N = 10_000


def _u32_inputs(seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    return x


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _eq_u32(port, jax_val):
    np.testing.assert_array_equal(port.numpy().astype(np.uint64),
                                  np.asarray(jax_val).astype(np.uint64))


class TestRng:
    def test_wang_hash_bit_exact(self):
        x = _u32_inputs(0)
        _eq_u32(trng.wang_hash(_t(x)), jrng.wang_hash(jnp.asarray(x)))

    def test_rand01_chain_bit_exact(self):
        s_t, s_j = _t(_u32_inputs(1)), jnp.asarray(_u32_inputs(1))
        for _ in range(4):
            v_t, s_t = trng.rand01(s_t)
            v_j, s_j = jrng.rand01(s_j)
            _eq_u32(s_t, s_j)
            np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        assert v_t.dtype == torch.float32

    def test_pixel_seed_bit_exact(self):
        rs = np.random.RandomState(2)
        x, y = rs.randint(0, 4096, N), rs.randint(0, 4096, N)
        f = rs.randint(0, 2**31, N)
        _eq_u32(trng.pixel_seed(_t(x), _t(y), _t(f)),
                jrng.pixel_seed(jnp.asarray(x, jnp.uint32),
                                jnp.asarray(y, jnp.uint32),
                                jnp.asarray(f, jnp.uint32)))

    def test_threefry_bit_exact(self):
        k0, k1 = _u32_inputs(3), _u32_inputs(4)
        c0, c1 = _u32_inputs(5), _u32_inputs(6)
        a0, a1 = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
        b0, b1 = jrng.threefry2x32(*(jnp.asarray(v) for v in (k0, k1, c0, c1)))
        _eq_u32(a0, b0)
        _eq_u32(a1, b1)

    def test_counter_stream_bit_exact(self):
        rs = np.random.RandomState(7)
        x, y = rs.randint(0, 2048, N), rs.randint(0, 2048, N)
        t = trng.CounterRng.from_pixel(_t(x), _t(y), 5, 3)
        j = jrng.CounterRng.from_pixel(jnp.asarray(x, jnp.uint32),
                                       jnp.asarray(y, jnp.uint32), 5, 3)
        for _ in range(3):
            vt, t = t.next01()
            vj, j = j.next01()
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _vec(rs, n=N, unit=False):
    """The same f32 vectors for both packages (normalized in float64 and
    rounded once when ``unit``, so both functions see identical input)."""
    a = rs.randn(n, 3)
    if unit:
        a /= np.linalg.norm(a, axis=1, keepdims=True)
    a = a.astype(np.float32)
    return (tvm.Vec3(*(torch.as_tensor(a[:, i]) for i in range(3))),
            jvm.Vec3(*(jnp.asarray(a[:, i]) for i in range(3))))


def _close3(t, j, rtol=1e-6, atol=0.0):
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


class TestVecmath:
    def test_dot_cross_normalize_reflect(self):
        rs = np.random.RandomState(10)
        (ut, uj), (vt, vj) = _vec(rs), _vec(rs)
        np.testing.assert_allclose(tvm.dot3(ut, vt).numpy(),
                                   np.asarray(jvm.dot3(uj, vj)), rtol=1e-6)
        _close3(tvm.cross(ut, vt), jvm.cross(uj, vj))
        _close3(tvm.normalize(ut), jvm.normalize(uj))
        nt, nj = _vec(rs, unit=True)
        _close3(tvm.reflect(ut, nt), jvm.reflect(uj, nj))

    @pytest.mark.parametrize("eta", [1.0 / 1.1, 1.1, 1.5])
    def test_refract_with_tir(self, eta):
        rs = np.random.RandomState(11)
        (vt, vj), (nt, nj) = _vec(rs, unit=True), _vec(rs, unit=True)
        out_t = tvm.refract(vt, nt, eta)
        _close3(out_t, jvm.refract(vj, nj, eta), atol=1e-7)
        if eta > 1.0:  # some rays undergo total internal reflection
            tir = (out_t.x == 0) & (out_t.y == 0) & (out_t.z == 0)
            assert bool(tir.any())

    def test_fresnel_both_directions(self):
        rs = np.random.RandomState(12)
        (nt, nj), (it, ij) = _vec(rs, unit=True), _vec(rs, unit=True)
        n1 = rs.choice([1.0, 1.1, 1.5], N).astype(np.float32)
        n2 = rs.choice([1.0, 1.1, 1.5], N).astype(np.float32)
        f0 = rs.rand(N).astype(np.float32) * 0.1
        got = tvm.fresnel_reflect_amount(torch.as_tensor(n1),
                                         torch.as_tensor(n2), nt, it,
                                         torch.as_tensor(f0), 1.0)
        want = jvm.fresnel_reflect_amount(jnp.asarray(n1), jnp.asarray(n2),
                                          nj, ij, jnp.asarray(f0),
                                          jnp.float32(1.0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


class TestSampling:
    def test_normalized3(self):
        seeds = _u32_inputs(20)
        vt, rt = tsampling.random_unit_vector_normalized3(
            trng.WangRng(_t(seeds)))
        vj, rj = jsampling.random_unit_vector_normalized3(
            jrng.WangRng(jnp.asarray(seeds)))
        _close3(vt, vj)
        _eq_u32(rt.state, rj.state)

    def test_zangle(self):
        """cos/sin of two libraries may differ by an ulp of a result of
        magnitude <= 1, hence the absolute term."""
        seeds = _u32_inputs(21)
        vt, rt = tsampling.random_unit_vector_zangle(trng.WangRng(_t(seeds)))
        vj, rj = jsampling.random_unit_vector_zangle(
            jrng.WangRng(jnp.asarray(seeds)))
        _close3(vt, vj, atol=1e-6)
        _eq_u32(rt.state, rj.state)


class TestColor:
    def _img(self):
        rs = np.random.RandomState(30)
        a = (rs.rand(3, 64, 32) * 4.0).astype(np.float32)
        a[:, 0, :4] = [0.0, 1e-4, 0.0031, 100.0]
        return (tvm.Vec3(*(torch.as_tensor(c) for c in a)),
                jvm.Vec3(*(jnp.asarray(c) for c in a)))

    def test_aces_srgb_postprocess(self):
        t, j = self._img()
        _close3(tcolor.aces_film(t), jcolor.aces_film(j))
        _close3(tcolor.linear_to_srgb(t), jcolor.linear_to_srgb(j))
        _close3(tcolor.srgb_to_linear(tcolor.aces_film(t)),
                jcolor.srgb_to_linear(jcolor.aces_film(j)))
        _close3(tcolor.postprocess_color(t, 1.5),
                jcolor.postprocess_color(j, 1.5))

    def test_to_u8(self):
        t, j = self._img()
        got = tcolor.to_u8(tcolor.aces_film(t)).numpy()
        want = np.asarray(jcolor.to_u8(jcolor.aces_film(j)))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


class TestConfig:
    def test_shared_defaults_match(self):
        from cpuperformanceraytracer_tpu.config import RenderConfig as J
        from cpuperformanceraytracer_tpu_torch.config import RenderConfig as T

        t, j = T(), J()
        shared = [f.name for f in dataclasses.fields(T) if f.name != "backend"]
        assert len(shared) == 19   # remat_bounces since the oracle's port
        for name in shared:
            assert getattr(t, name) == getattr(j, name), name

    def test_validation(self):
        from cpuperformanceraytracer_tpu_torch.config import RenderConfig as T

        with pytest.raises(ValueError, match="backend"):
            T(backend="pallas").validate()
        with pytest.raises(ValueError, match="spp"):
            T(spp=0).validate()
        with pytest.raises(ValueError, match="env_mode"):
            T(env_mode="sphere").validate()
        assert T(env_mode="cubemap", env_sampling="bilinear").validate()
        assert T(env_mode="none", env_sampling="bilinear").validate()
