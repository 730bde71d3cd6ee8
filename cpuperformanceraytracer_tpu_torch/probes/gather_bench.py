"""The gather race (K7): which way of fetching env texels is fastest?

Counterpart of ``scripts/gather_bench.py``: 921600 (1280 x 720) queries
into a 512 x 256 f32 RGB texture, uniform rows and columns. The entries:

1. ``plane[flat]`` on each of the three channel planes (torch; the
   script's ``xla_take``);
2. ``index_select`` of the (N, 3) rows (torch; its ``xla_take_rows``);
3. kernel E's texel fetch, ``kernels.env_gather.gather_texels`` (the
   counterpart of the TPU's one-hot MXU gather);
4. K7, ``texel_gather`` (``csrc/probes/texel_gather.cu``, 4 queries a
   thread, the table read through L1): on the one plane, as the script's
   ``pallas_tga``; on the three planes; and on a packed (N, 4) RGBX
   table, one 16-byte load a query.

Each is timed with CUDA events on the GPU (the host clock, and the plain
versions, on the CPU) and held bit for bit against ``plane[flat]``.
The inputs come from ``numpy.random.default_rng(seed)``; the script's
``jax.random`` draws are not reproduced (the race depends on their
distribution, not on their values).

    python -m cpuperformanceraytracer_tpu_torch.probes.gather_bench
    python -m cpuperformanceraytracer_tpu_torch.probes.gather_bench --backend torch
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.config import resolve_device
from cpuperformanceraytracer_tpu_torch.kernels._build import PROBES, check, load_library
from cpuperformanceraytracer_tpu_torch.kernels.env_gather import gather_texels
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture
from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

H, W = 256, 512
P = 1280 * 720


def bench_inputs(seed: int = 0):
    """(H, W, 3) f32 texture in [0, 1) and P uniform int32 rows, cols."""
    rng = np.random.default_rng(seed)
    tex = rng.random((H, W, 3), dtype=np.float32)
    rows = rng.integers(0, H, P, dtype=np.int32)
    cols = rng.integers(0, W, P, dtype=np.int32)
    return tex, rows, cols


def texel_gather_reference(table, idx, packed: bool = False) -> torch.Tensor:
    """Plain version: ``table[:, idx]`` of (C, N) planes, or ``table[idx]``
    of an (N, 4) packed table; indices clamped to [0, N)."""
    n = table.shape[0] if packed else table.shape[1]
    i = idx.clamp(0, n - 1).to(torch.int64)
    return table[i] if packed else table[:, i]


def texel_gather(table, idx, packed: bool = False) -> torch.Tensor:
    """K7 wrapper: (C, *idx.shape) texels of (C, N) f32 planes, or
    (*idx.shape, 4) rows of a packed (N, 4) f32 table; idx int32."""
    if idx.device.type == "cpu":
        return texel_gather_reference(table, idx, packed)
    if idx.device.type != "cuda":
        raise ValueError(f"texel_gather: unsupported device {idx.device}")
    if table.dim() != 2 or (packed and table.shape[1] != 4) \
            or table.dtype != torch.float32 or not table.is_contiguous() \
            or table.device != idx.device or table.data_ptr() % 16 \
            or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"texel_gather: table {tuple(table.shape)} "
                         f"{table.dtype}, idx {tuple(idx.shape)} {idx.dtype}"
                         f" (packed={packed})")
    entries, planes = (table.shape[0], 0) if packed else table.shape[::-1]
    n = idx.numel()
    if packed:
        out = torch.empty((*idx.shape, 4), dtype=torch.float32, device=idx.device)
    else:
        # out shares idx's offset modulo 16 bytes, so a view of idx that
        # starts off 16 bytes still takes the vector body
        buf = torch.empty(planes * n + 3, dtype=torch.float32, device=idx.device)
        skip = (idx.data_ptr() - buf.data_ptr()) % 16 // 4
        out = buf[skip:skip + planes * n].view(planes, *idx.shape)
    if n == 0:
        return out
    err = load_library(PROBES).cprt_texel_gather(
        table.data_ptr(), entries, planes, idx.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(idx.device).cuda_stream)
    check(err, "texel_gather", PROBES)
    texel_gather.launches += 1
    return out


texel_gather.launches = 0


def run(device, seed: int = 0, iters: int = 100) -> dict:
    """The race: each entry's ms and whether it equals ``plane[flat]``."""
    device = torch.device(device)
    tex, rows_n, cols_n = bench_inputs(seed)
    texf = torch.from_numpy(tex.reshape(-1, 3)).to(device)            # (N, 3)
    planes = texf.t().contiguous()                                     # (3, N)
    packed = torch.cat([texf, torch.zeros_like(texf[:, :1])], 1).contiguous()
    rows = torch.from_numpy(rows_n).to(device)
    cols = torch.from_numpy(cols_n).to(device)
    flat = rows * W + cols                                             # int32
    flat64 = flat.long()
    want = planes[:, flat64]                                           # (3, P)
    texture = Texture(r=planes[0], g=planes[1], b=planes[2], width=W, height=H)
    entries = [
        ("torch plane[flat] x3", lambda: torch.stack(
            [planes[0][flat64], planes[1][flat64], planes[2][flat64]]),
         lambda o: o),
        ("torch index_select rows (N,3)", lambda: texf.index_select(0, flat64),
         lambda o: o.t()),
        ("kernel E gather_texels (N,4)", lambda: gather_texels(texture, rows, cols),
         lambda o: o[:, :3].t()),
        ("K7 planar, 1 plane (pallas_tga)", lambda: texel_gather(planes[:1], flat),
         lambda o: o),
        ("K7 planar, 3 planes", lambda: texel_gather(planes, flat), lambda o: o),
        ("K7 packed (N,4)", lambda: texel_gather(packed, flat, packed=True),
         lambda o: o[:, :3].t()),
    ]
    where = "" if device.type == "cuda" else " (CPU host clock)"
    ms, correct = {}, {}
    for name, fn, as_planes in entries:
        got = as_planes(fn())
        ms[name] = device_ms(fn, iters, device)
        correct[name] = bool(torch.equal(got, want[:got.shape[0]]))
        print(f"{name:40s} {ms[name]:10.4f} ms{where}", flush=True)
        print(f"   correct: {correct[name]}")
    return dict(ms=ms, correct=correct, planes=planes, packed=packed,
                flat=flat, rows=rows, cols=cols)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=100)
    a = p.parse_args(argv)
    run(resolve_device(a.backend), a.seed, a.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
