"""Kernel D (the env cotangents and the texel scatter): its plain version
vs the JAX ``segment_sum_sorted`` and the cotangent products of
``kernels/backward.py:642-653``, on numpy-seeded indices and values, and
the frame-scale rounding bound of ``tests/test_diff_pallas.py``.
No interpret-mode call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpuperformanceraytracer_tpu.diff.segsum import segment_sum_sorted
from cpuperformanceraytracer_tpu_torch.kernels.env_backward import (
    env_backward,
    env_backward_reference,
)
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture


def _texture(rgb):
    rgb = np.asarray(rgb, np.float32)
    return Texture(*(torch.from_numpy(rgb[:, c].copy()) for c in range(3)),
                   rgb.shape[0], 1)


def _run(g, idx, mt, rgb):
    return env_backward(torch.from_numpy(g), torch.from_numpy(idx),
                        torch.from_numpy(mt), _texture(rgb))


def test_matches_jax_segment_sum_and_cot_products():
    rng = np.random.RandomState(0)
    h, w, n_tex = 16, 64, 50
    idx = rng.randint(0, n_tex, size=(h, w)).astype(np.int64)
    g = rng.randn(3, h, w).astype(np.float32)
    mt = rng.rand(3, h, w).astype(np.float32)
    rgb = rng.rand(n_tex, 3).astype(np.float32)
    cot, d_tex = _run(g, idx, mt, rgb)

    want_d = segment_sum_sorted(
        jnp.asarray(idx.reshape(-1), jnp.int32),
        tuple(jnp.asarray((g[c] * mt[c]).reshape(-1)) for c in range(3)),
        n_tex)
    for c in range(3):
        want_cot = np.asarray(jnp.asarray(g[c]) * jnp.asarray(rgb[idx, c]))
        assert np.abs(want_cot).max() > 0.0
        np.testing.assert_array_equal(cot[c].numpy(), want_cot)
        want = np.asarray(want_d[c])
        assert np.abs(want).max() > 0.0
        np.testing.assert_allclose(d_tex[c].numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_empty_segments():
    idx = np.asarray([[3, 3, 7]], np.int64)
    g = np.zeros((3, 1, 3), np.float32)
    g[0, 0] = [1.0, 2.0, 4.0]
    mt = np.ones((3, 1, 3), np.float32)
    _, d_tex = _run(g, idx, mt, np.ones((10, 3), np.float32))
    (want,) = segment_sum_sorted(jnp.asarray([3, 3, 7], jnp.int32),
                                 [jnp.asarray([1.0, 2.0, 4.0])], 10)
    expect = np.zeros(10, np.float32)
    expect[3], expect[7] = 3.0, 4.0
    np.testing.assert_array_equal(d_tex[0].numpy(), expect)
    np.testing.assert_allclose(np.asarray(want), expect)
    assert not torch.any(d_tex[1]) and not torch.any(d_tex[2])


@pytest.mark.parametrize("name,rel_bound", [("mixed", 1e-4),
                                            ("positive", 1e-2)])
def test_frame_scale_rounding_error(name, rel_bound):
    """720p pixels into 512x256 texels against a float64 np.add.at: the
    bound of test_frame_scale_rounding_error (a few ulp of the total
    magnitude), mixed signs and the all-positive case."""
    p, n_tex = 1280 * 720, 512 * 256
    rng = np.random.RandomState(7)
    idx = rng.randint(0, n_tex, size=p).astype(np.int64)
    v = rng.randn(p).astype(np.float32)
    if name == "positive":
        v = np.abs(v)
    g = np.zeros((3, 720, 1280), np.float32)
    g[0] = v.reshape(720, 1280)
    mt = np.ones_like(g)
    _, d_tex = _run(g, idx.reshape(720, 1280), mt,
                    np.ones((n_tex, 3), np.float32))
    want = np.zeros(n_tex, np.float64)
    np.add.at(want, idx, v.astype(np.float64))
    err = np.abs(d_tex[0].numpy().astype(np.float64) - want)
    scale = np.abs(v.astype(np.float64)).sum() * 2 ** -23
    assert err.max() <= 4 * scale, (name, err.max(), scale)
    rel = np.linalg.norm(err) / max(np.linalg.norm(want), 1e-9)
    assert rel < rel_bound, (name, rel)


def test_wrapper_contract():
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(3, 4, 8).astype(np.float32))
    mt = torch.from_numpy(rng.rand(3, 4, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 6, size=(4, 8)).astype(np.int64))
    tex = _texture(rng.rand(6, 3))
    before = env_backward.launches
    a = env_backward(g, idx, mt, tex)
    b = env_backward_reference(g, idx, mt, tex)
    assert env_backward.launches == before  # the CPU path launches nothing
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    meta = Texture(*(t.to("meta") for t in tex[:3]), tex.width, tex.height)
    with pytest.raises(ValueError, match="unsupported device"):
        env_backward(g.to("meta"), idx.to("meta"), mt.to("meta"), meta)


def test_zero_addends_change_no_texel_sum():
    """Kernel D skips the addends g * mt that are +0.0 or -0.0. The plain
    texel sums over only the nonzero addends are bit-equal to those over
    all of them, and both match the JAX segment_sum_sorted; the cases
    hold -0.0 addends and a NaN addend (on the last texel, where the JAX
    prefix sum carries a NaN into no other segment)."""
    rng = np.random.RandomState(3)
    h, w, n_tex = 8, 32, 40
    idx = rng.randint(0, n_tex - 1, size=(h, w)).astype(np.int64)
    idx[:, :6] = 9                                   # a run of equal indices
    g = rng.randn(3, h, w).astype(np.float32)
    mt = rng.rand(3, h, w).astype(np.float32)
    mt[:, ::2, ::3] = 0.0
    mt[:, 1::2, ::3] = -0.0                          # -0.0 * g: a signed zero
    g[2, 0, :6] = -0.0
    idx[5, 7] = n_tex - 1
    mt[1, 5, 7] = np.nan
    rgb = rng.rand(n_tex, 3).astype(np.float32)
    _, d_all = _run(g, idx, mt, rgb)

    flat = torch.from_numpy(idx.reshape(-1))
    want = segment_sum_sorted(jnp.asarray(idx.reshape(-1), jnp.int32),
                              tuple(jnp.asarray((g[c] * mt[c]).reshape(-1))
                                    for c in range(3)), n_tex)
    for c in range(3):
        v = torch.from_numpy((g[c] * mt[c]).reshape(-1))
        keep = v != 0                                # NaN != 0: kept
        assert (~keep).sum() > 0 and (v == 0).logical_and(torch.signbit(v)).any()
        d_nz = torch.zeros(n_tex).index_add_(0, flat[keep], v[keep])
        assert torch.equal(d_nz.view(torch.int32), d_all[c].view(torch.int32))
        np.testing.assert_allclose(d_all[c].numpy(), np.asarray(want[c]),
                                   rtol=1e-5, atol=1e-5)
    assert np.isnan(d_all[1][n_tex - 1].item())
    assert np.isfinite(d_all[1][:n_tex - 1].numpy()).all()


@pytest.mark.parametrize("case", ["one_texel_3433", "zero_run"])
def test_kernel_order_model_within_k_term_bound(case):
    """Kernel D's order (run records, stable sort, segmented sum), as the
    plain-torch model of torch_port_helpers, against index_add_ and a
    float64 sum: each texel's sum of k addends within (k - 1) * 2^-24 *
    sum|v| (at least 8 * 2^-24 * sum|v|) of the exact sum, as index_add_'s.
    ``one_texel_3433``: the busiest texel of the 720p training step, hit
    by 3433 pixels in runs among others; ``zero_run``: a run of zero
    addends (a never-missed pixel) is dropped and its texel stays +0.0."""
    from torch_port_helpers import kernel_d_order

    rng = np.random.RandomState(12)
    h, w, n_tex = 48, 128, 300
    idx = rng.randint(0, n_tex, size=(h, w)).astype(np.int64)
    g = rng.randn(3, h, w).astype(np.float32)
    mt = rng.rand(3, h, w).astype(np.float32)
    if case == "one_texel_3433":
        run = np.arange(1000, 1400)                 # one long run, too
        rest = rng.permutation(np.setdiff1d(np.arange(h * w), run))[:3033]
        idx[idx == 7] = 8
        idx.reshape(-1)[np.concatenate([run, rest])] = 7
        assert (idx == 7).sum() == 3433
    else:
        idx[3, 10:50] = 299                          # texel 299: this run only
        idx[idx == 299] = 298
        idx[3, 10:50] = 299
        mt[:, 3, 10:50] = 0.0
    flat = torch.from_numpy(idx.reshape(-1))
    got = kernel_d_order(torch.from_numpy(g), torch.from_numpy(idx),
                         torch.from_numpy(mt), n_tex)
    count = torch.bincount(flat, minlength=n_tex).double()
    allow = torch.clamp(count - 1.0, min=8.0) * 2.0 ** -24
    for c in range(3):
        v = torch.from_numpy(g[c] * mt[c]).reshape(-1)
        exact = torch.zeros(n_tex, dtype=torch.float64).index_add_(0, flat, v.double())
        mag = torch.zeros(n_tex, dtype=torch.float64).index_add_(0, flat, v.abs().double())
        library = torch.zeros(n_tex).index_add_(0, flat, v)
        for name, d in (("model", got[c]), ("index_add_", library)):
            err = (d.double() - exact).abs()
            assert (err <= allow * mag).all(), (name, c, (err / (allow * mag)).max())
        assert mag.max() > 0
    if case == "zero_run":
        assert all(d[299].item() == 0.0 and not torch.signbit(d[299]) for d in got)
    else:
        assert all(d[7] != 0 for d in got)
