"""Kernels F (combine + accumulate) and G (display transform): their
plain versions against the JAX package, on the CPU.

- plain F vs JAX ``combine_accumulate`` in interpret mode (W % 128 == 0,
  spp 1 and 2, rtol 1e-6: the same operation order), and the in-kernel
  sample mean of per-sample rgb planes vs kernel A's own mean;
- plain G vs JAX ``postprocess_pallas`` (32x256, interpret mode) and vs
  ``postprocess_color`` on an awkward 7x13 shape, and the u8 image of
  ``postprocess_image`` vs the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one torch thread per worker)
from cpuperformanceraytracer_tpu.core.color import postprocess_color
from cpuperformanceraytracer_tpu.core.vecmath import Vec3 as JVec3
from cpuperformanceraytracer_tpu.kernels.combine import (
    combine_accumulate as jax_combine,
)
from cpuperformanceraytracer_tpu.kernels.tonemap import postprocess_pallas
from cpuperformanceraytracer_tpu.render.frame import postprocess_image as jax_image
from cpuperformanceraytracer_tpu_torch.kernels.combine import (
    combine_accumulate,
    inv_spp,
)
from cpuperformanceraytracer_tpu_torch.kernels.tonemap import tonemap
from cpuperformanceraytracer_tpu_torch.render.frame import postprocess_image

H, W = 16, 256


def _vec(a):
    return JVec3(*(jnp.asarray(c) for c in a))


def _inputs(spp, seed):
    rs = np.random.RandomState(seed)
    lead = () if spp == 1 else (spp,)
    e4 = rs.rand(*lead, H * W, 4).astype(np.float32)
    rgb = rs.rand(3, H, W).astype(np.float32)
    thr = rs.rand(*lead, 3, H, W).astype(np.float32)
    acc = (rs.rand(3, H, W) * 2).astype(np.float32)
    return e4, rgb, thr, acc


@pytest.mark.parametrize("spp", [1, 2])
def test_combine_matches_jax(spp):
    e4, rgb, thr, acc = _inputs(spp, seed=spp)
    blend = 0.25
    thr_j = _vec(thr if spp == 1 else np.moveaxis(thr, 1, 0))
    want = jax_combine(jnp.asarray(e4), _vec(rgb), thr_j, _vec(acc), blend)
    got = combine_accumulate(torch.as_tensor(e4), torch.as_tensor(rgb),
                             torch.as_tensor(thr), torch.as_tensor(acc),
                             blend)
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(c)
                                                      for c in want]),
                               rtol=1e-6, atol=1e-7)


def test_combine_frame0_and_per_sample_mean():
    """blend 1 stores the frame's colour; per-sample rgb planes (views
    of a (spp, 12, H, W) buffer) give kernel A's own sample mean."""
    spp = 3
    rs = np.random.RandomState(5)
    planes = torch.as_tensor(rs.rand(spp, 12, H, W).astype(np.float32))
    e4 = torch.as_tensor(rs.rand(spp, H * W, 4).astype(np.float32))
    mean = torch.zeros((3, H, W))
    for s in range(spp):                  # kernel A: acc += ret * inv_spp
        mean = mean + planes[s, 0:3] * inv_spp(spp)
    want = combine_accumulate(e4, mean, planes[:, 6:9],
                              torch.full((3, H, W), 7.0), 1.0)
    got = combine_accumulate(e4, planes[:, 0:3], planes[:, 6:9],
                             torch.full((3, H, W), 7.0), 1.0)
    assert torch.equal(got, want)
    env = e4[..., :3].permute(0, 2, 1).reshape(spp, 3, H, W)
    torch.testing.assert_close(
        got, mean + (env * planes[:, 6:9]).sum(0) * inv_spp(spp),
        rtol=1e-6, atol=1e-6)


def test_tonemap_matches_pallas_and_xla():
    rs = np.random.RandomState(0)
    acc = (rs.rand(3, 32, 256) * 3).astype(np.float32)
    acc[0, 0, :4] = (0.0, 1e-12, 1e-3, 50.0)
    got = tonemap(torch.as_tensor(acc), 1.0).numpy()
    want = postprocess_pallas(_vec(acc), 1.0)
    np.testing.assert_allclose(got, np.stack([np.asarray(c) for c in want]),
                               rtol=1e-5, atol=1e-6)
    odd = (rs.rand(3, 7, 13) * 4).astype(np.float32)
    got = tonemap(torch.as_tensor(odd), 0.7).numpy()
    want = postprocess_color(_vec(odd), 0.7)
    assert got.shape == (3, 7, 13)
    np.testing.assert_allclose(got, np.stack([np.asarray(c) for c in want]),
                               rtol=1e-5, atol=1e-6)
    assert ((got >= 0.0) & (got <= 1.0)).all()


def test_postprocess_image_u8_matches_jax():
    rs = np.random.RandomState(2)
    acc = (rs.rand(3, 24, 40) * 5).astype(np.float32)
    got = postprocess_image(torch.as_tensor(acc), 1.3)
    want = np.asarray(jax_image(_vec(acc), 1.3))
    assert got.dtype == torch.uint8 and got.shape == (24, 40, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
