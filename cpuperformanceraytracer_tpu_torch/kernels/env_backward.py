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

The plain version adds every addend with ``index_add_`` on the tensor's
device: on the CPU one pass in pixel order, on the card with atomics in
arrival order. The kernel (``csrc/env_backward.cu``) sums in a fixed
order, so the same inputs give the same bits on every run, following the
reference's sort and segmented sum: a warp sums each run of equal
indices among 32 neighbouring pixels in lane order and writes it as a
record into a fixed slot (runs whose sums are +0.0 or -0.0 are dropped:
a never-missed pixel has mt = 0), a stable ``torch.sort`` of the slots'
texel keys keeps a texel's records in pixel order (the reference sorts
with XLA outside its kernels), and a second kernel adds each texel's
records in that order and writes the three planes.

``env_backward`` is the wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (counted in ``env_backward.launches``);
any other device raises.

A pixel-row window of the frame (``parallel/shard.py``) needs nothing
here: the kernel works on its pixels' run records, whatever rows they
are, so a window's (3, h, W) cotangents and indices go in as they are.
"""

from __future__ import annotations

import torch

from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library
from cpuperformanceraytracer_tpu_torch.utils.profiling import count_launch


def env_backward_reference(g, idx, mt, texture):
    """Plain-torch kernel D: ``(cot_mt, (d_r, d_g, d_b))``; the texel sums
    are ``index_add_`` of every addend (in pixel order on the CPU)."""
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
    n_tex, n = texture.r.numel(), idx.numel()
    m = (n + 31) // 32 * 32  # a slot for each lane of each chunk of 32 pixels
    cot_mt = torch.empty_like(g)
    d_tex = torch.empty((3, n_tex), dtype=torch.float32, device=g.device).unbind(0)
    keys = torch.empty(m, dtype=torch.int32, device=g.device)
    recs = torch.empty((m, 4), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    lib = load_library()
    check(lib.cprt_env_backward_runs(
        g.data_ptr(), idx.data_ptr(), mt.data_ptr(), texture.r.data_ptr(),
        texture.g.data_ptr(), texture.b.data_ptr(), cot_mt.data_ptr(),
        keys.data_ptr(), recs.data_ptr(), *(d.data_ptr() for d in d_tex), n,
        n_tex, stream), "env_backward")
    sorted_keys, order = torch.sort(keys, stable=True)
    check(lib.cprt_env_backward_sums(
        sorted_keys.data_ptr(), order.data_ptr(), recs.data_ptr(), m, n_tex,
        *(d.data_ptr() for d in d_tex), stream), "env_backward")
    count_launch(env_backward)
    return cot_mt, d_tex


env_backward.launches = 0
