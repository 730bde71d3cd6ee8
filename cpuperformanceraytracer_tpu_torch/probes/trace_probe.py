"""The trace probe (K6): can the trace's dot products use the tensor cores?

Counterpart of ``scripts/mxu_trace_probe.py``. Per pixel of a 1280x720
frame, 9 chained bounce segments, each taking the 54 dot products of an
8-feature vector with the rows of ``B`` (54, 8): ``acc += U0 U1 - U2 +
U3 + ... + U53``, then feature 0 becomes ``acc * 1e-6``. ``trace_dots``
runs it on the CUDA cores (mul/add chains, as the script's VPU body) or
on the tensor cores (TF32 products split 3 ways for near-f32, as its MXU
body at ``Precision.HIGHEST``): per warp with ``mma.sync``
(``tensor_core``) or per warpgroup with ``wgmma``, Hopper's full-rate
instruction (``wgmma``). ``csrc/probes/trace_dots.cu`` has the designs.
``B`` and ``x`` are the script's own numpy draws.

    python -m cpuperformanceraytracer_tpu_torch.probes.trace_probe
    python -m cpuperformanceraytracer_tpu_torch.probes.trace_probe \\
        --backend torch --height 8 --width 256      # plain version, CPU

prints ms per frame-equivalent for each unit and the max relative error
of each tensor-core unit against the CUDA cores (max |a - b| / max |b|).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.config import resolve_device
from cpuperformanceraytracer_tpu_torch.kernels._build import PROBES, check, load_library
from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

H, W = 720, 1280
NF, NCOL, REPEAT = 8, 54, 9
UNITS = ("cuda_core", "tensor_core", "wgmma")   # index: cprt_trace_dots's unit


def probe_inputs(height: int = H, width: int = W):
    """The script's draws: ``B`` (54, 8) and ``x`` (8, height, width) f32."""
    B = np.random.default_rng(0).standard_normal((NCOL, NF)).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((NF, height, width))
    return x.astype(np.float32), B


def trace_dots_reference(x, B) -> torch.Tensor:
    """Plain version: the script's VPU body in its operation order."""
    b = B.tolist()                      # f32 values, exact as Python floats
    planes = list(x.unbind(0))
    acc = torch.zeros_like(planes[0])
    for _ in range(REPEAT):
        outs = []
        for c in range(NCOL):
            s = planes[0] * b[c][0]
            for f in range(1, NF):
                s = s + planes[f] * b[c][f]
            outs.append(s)
        acc = acc + outs[0] * outs[1] - outs[2]
        for u in outs[3:]:
            acc = acc + u
        planes[0] = acc * 1e-6
    return acc


def trace_dots(x, B, unit: str = "cuda_core") -> torch.Tensor:
    """K6 wrapper: ``acc`` (H, W) f32 of ``x`` (8, H, W) and ``B`` (54, 8)."""
    if unit not in UNITS:
        raise ValueError(f"trace_dots: unit {unit!r} not in {UNITS}")
    if x.device.type == "cpu":
        return trace_dots_reference(x, B)
    if x.device.type != "cuda":
        raise ValueError(f"trace_dots: unsupported device {x.device}")
    if x.dim() != 3 or x.shape[0] != NF or x.dtype != torch.float32 \
            or not x.is_contiguous() or B.shape != (NCOL, NF) \
            or B.dtype != torch.float32 or not B.is_contiguous() \
            or B.device != x.device:
        raise ValueError(f"trace_dots: x {tuple(x.shape)} {x.dtype}, "
                         f"B {tuple(B.shape)} {B.dtype} {B.device}")
    out = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    n = out.numel()
    if n == 0:
        return out
    err = load_library(PROBES).cprt_trace_dots(
        x.data_ptr(), B.data_ptr(), out.data_ptr(), n,
        UNITS.index(unit),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, f"trace_dots({unit})", PROBES)
    trace_dots.launches += 1
    return out


trace_dots.launches = 0


def max_rel_err(got, want) -> float:
    """The script's error: max |got - want| / max |want|."""
    return ((got - want).abs().max() / (want.abs().max() + 1e-9)).item()


def run(device, height: int = H, width: int = W, iters: int = 16) -> dict:
    """Time the three units on the script's inputs and print its three
    lines, then the wgmma unit's."""
    device = torch.device(device)
    xn, Bn = probe_inputs(height, width)
    x, B = torch.from_numpy(xn).to(device), torch.from_numpy(Bn).to(device)
    out, ms = {}, {}
    for unit in UNITS:
        out[unit] = trace_dots(x, B, unit)
        ms[unit] = device_ms(lambda: trace_dots(x, B, unit), iters, device, warm=1)
    err = max_rel_err(out["tensor_core"], out["cuda_core"])
    err_wgmma = max_rel_err(out["wgmma"], out["cuda_core"])
    where = "" if device.type == "cuda" else " (plain version, CPU host clock)"
    print(f"tensor core mma (3xTF32): {ms['tensor_core']:8.4f} "
          f"ms/frame-equivalent{where}")
    print(f"cuda core unrolled     : {ms['cuda_core']:8.4f} "
          f"ms/frame-equivalent{where}")
    print(f"max rel err tensor-core vs cuda-core: {err:.3e}")
    print(f"tensor core wgmma (3xTF32): {ms['wgmma']:8.4f} "
          f"ms/frame-equivalent{where}")
    print(f"max rel err wgmma vs cuda-core: {err_wgmma:.3e}")
    return dict(ms=ms, max_rel_err=err, max_rel_err_wgmma=err_wgmma, out=out,
                x=x, B=B)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--height", type=int, default=H)
    p.add_argument("--width", type=int, default=W)
    p.add_argument("--iters", type=int, default=16)
    a = p.parse_args(argv)
    run(resolve_device(a.backend), a.height, a.width, a.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
