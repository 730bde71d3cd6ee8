"""Kernel D: the env branch of the diff sample's backward, and its plain
version.

Replaces ``cpuperformanceraytracer_tpu/diff/segsum.py::segment_sum_sorted``
and the cotangent products of ``kernels/backward.py:642-653`` (XLA ops
on the TPU: a sort, a prefix sum and a gather, because TPU scatters
serialise). Given the colour cotangent ``g`` (3, H, W), kernel B's texel
index ``idx`` (H, W) int64, kernel A's miss-throughput planes ``mt``
(3, H, W) and the texture, it returns

    cot_mt (3, H, W) = g * tex[idx]            (d colour / d miss_thr)
    d_tex  3 x (T,)  : d_tex[c][idx[p]] += g[c][p] * mt[c][p]

On the card (``csrc/env_backward.cu``) the texel sum is one pass of f32
atomics: a warp sums each run of equal indices first, skips the runs
whose sums are +0.0 or -0.0 (a never-missed pixel has mt = 0), so the
set of addends shrinks but the sum does not change, and adds the three
channels of a run with one vector atomic into a (T, 4) scratch that a
second pass copies into the planes; the order in which the runs arrive
varies from run to run. The plain version uses ``index_add_`` over
every addend.

``env_backward`` is the wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (counted in ``env_backward.launches``);
any other device raises.
"""

from __future__ import annotations

import torch

from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library


def env_backward_reference(g, idx, mt, texture):
    """Plain-torch kernel D: ``(cot_mt, (d_r, d_g, d_b))``."""
    flat = idx.reshape(-1)
    planes = (texture.r, texture.g, texture.b)
    cot_mt = torch.stack([g[c] * planes[c][idx] for c in range(3)])
    d_tex = tuple(
        torch.zeros_like(planes[c]).index_add_(0, flat, (g[c] * mt[c]).reshape(-1))
        for c in range(3))
    return cot_mt, d_tex


def _check(g, idx, mt, texture):
    dev, shape = g.device, g.shape
    n_tex = texture.width * texture.height
    bad = []
    for name, t in (("g", g), ("mt", mt)):
        if (t.shape != shape or t.dim() != 3 or shape[0] != 3
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            bad.append(f"{name} {tuple(t.shape)} {t.dtype} {t.device}")
    if (idx.shape != shape[1:] or idx.dtype != torch.int64
            or not idx.is_contiguous() or idx.device != dev):
        bad.append(f"idx {tuple(idx.shape)} {idx.dtype} {idx.device}")
    for t in (texture.r, texture.g, texture.b):
        if (t.shape != (n_tex,) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != dev):
            bad.append(f"texture plane {tuple(t.shape)} {t.dtype} {t.device}")
    if n_tex >= 2 ** 31:
        bad.append(f"{n_tex} texels (the kernel takes < 2^31)")
    if bad:
        raise ValueError("env_backward: " + "; ".join(bad))


def env_backward(g, idx, mt, texture):
    """Kernel D wrapper: ``(cot_mt, (d_r, d_g, d_b))``."""
    if g.device.type == "cpu":
        return env_backward_reference(g, idx, mt, texture)
    if g.device.type != "cuda":
        raise ValueError(f"env_backward: unsupported device {g.device}")
    _check(g, idx, mt, texture)
    n_tex = texture.r.numel()
    cot_mt = torch.empty_like(g)
    d_tex = torch.empty((3, n_tex), dtype=torch.float32, device=g.device).unbind(0)
    sums = torch.empty((n_tex, 4), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = load_library().cprt_env_backward(
        g.data_ptr(), idx.data_ptr(), mt.data_ptr(), texture.r.data_ptr(),
        texture.g.data_ptr(), texture.b.data_ptr(), cot_mt.data_ptr(),
        *(d.data_ptr() for d in d_tex), idx.numel(), sums.data_ptr(), n_tex,
        stream)
    check(err, "env_backward")
    env_backward.launches += 1
    return cot_mt, d_tex


env_backward.launches = 0
