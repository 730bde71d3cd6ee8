"""The overlap probe: can the env gather hide behind kernel A, and could
texels be fetched into on-chip memory inside a kernel?

Counterpart of ``scripts/overlap_probe.py``; ``p1``, ``p2`` and ``p3``
select as in the script (default: all three).

P1. Kernel A alone (no-env forward, 1280x720 ``glass_spheres``, 8
    bounces, wang RNG); kernel E's texel fetch alone, on the 921600 real
    miss indices of a rendered frame (kernel B's ``index_out`` with
    ``gradient_sky(512, 256)``); both at once on two CUDA streams with no
    dependency between them; a trivial launch. If "together" is below
    "kernel + gather", the card runs the two at once (the TPU ran one op
    at a time). No new kernel.
P2. K8a, ``row_copy`` (``csrc/probes/row_copy.cu``): n copies of a table
    row into shared memory with up to ``depth`` in flight (1, 2, 4, 8;
    depth 1 is the script's serial start-then-wait), by TMA bulk copy and
    by ``cp.async``, at the script's 512-byte row and the real 16-byte
    texel row: ns per copy at each depth.
P3. K8b, ``dsmem_gather`` (``csrc/probes/dsmem_gather.cu``): a gather
    from a (256, 512) f32 table held in the shared memory of a cluster of
    4 blocks, at the script's (16, 128) queries and at the gather race's
    921600 queries, beside K7's gather through L2 and ``table[rows, cols]``.

Times: CUDA events on the GPU; on the CPU (``--backend torch``) the
plain versions, the host clock, and P1 without streams.

    python -m cpuperformanceraytracer_tpu_torch.probes.overlap_probe [p1|p2|p3]
    python -m cpuperformanceraytracer_tpu_torch.probes.overlap_probe \\
        --backend torch --width 64 --height 32
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.config import RenderConfig, resolve_device
from cpuperformanceraytracer_tpu_torch.kernels._build import PROBES, check, load_library
from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

W, H = 1280, 720
TABLE_ROWS = 131072                    # P2's table: (131072, 128) f32
SLOTS = 8                              # P2's on-chip buffer: (8, row)
COPIES = (256, 1024, 4096)
DEPTHS = (1, 2, 4, 8)                  # copies in flight; 1 is serial
ROW_FLOATS = (128, 4)                  # 512-byte and 16-byte rows
MECHANISMS = ("tma", "cp_async")
TH, TW = 256, 512                      # P3's table
CLUSTER = 4                            # blocks holding P3's table
VEC = 4                                # K8b's queries a thread and iteration


def row_copy_reference(table, idx) -> torch.Tensor:
    """Plain K8a: out[s] = table[idx[max{i < n: i % 8 == s}]], else 0."""
    out = torch.zeros((SLOTS, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    n = idx.numel()
    s = torch.arange(min(n, SLOTS), device=idx.device)
    last = s + SLOTS * ((n - 1 - s) // SLOTS)
    out[s] = table[idx[last].clamp(0, table.shape[0] - 1).long()]
    return out


def row_copy(table, idx, mechanism: str = "tma", depth: int = SLOTS) -> torch.Tensor:
    """K8a wrapper: the (8, row) buffer after copying row idx[i] of
    ``table`` (rows of 16 to 512 bytes) into slot i % 8, with up to
    ``depth`` (1..8) copies in flight; the plain version ignores it."""
    if mechanism not in MECHANISMS:
        raise ValueError(f"row_copy: mechanism {mechanism!r} not in {MECHANISMS}")
    if not (isinstance(depth, int) and 1 <= depth <= SLOTS):
        raise ValueError(f"row_copy: depth {depth!r} not in 1..{SLOTS}")
    if idx.device.type == "cpu":
        return row_copy_reference(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"row_copy: unsupported device {idx.device}")
    if table.dim() != 2 or table.shape[1] % 4 or not 0 < table.shape[1] <= 128 \
            or table.dtype != torch.float32 or not table.is_contiguous() \
            or table.data_ptr() % 16 or table.device != idx.device \
            or idx.dim() != 1 or idx.dtype != torch.int32 \
            or not idx.is_contiguous():
        raise ValueError(f"row_copy: table {tuple(table.shape)} {table.dtype}, "
                         f"idx {tuple(idx.shape)} {idx.dtype}")
    out = torch.empty((SLOTS, table.shape[1]), dtype=torch.float32,
                      device=idx.device)
    err = load_library(PROBES).cprt_row_copy(
        table.data_ptr(), table.shape[0], table.shape[1], idx.data_ptr(),
        idx.numel(), out.data_ptr(), int(mechanism == "tma"), depth,
        torch.cuda.current_stream(idx.device).cuda_stream)
    check(err, f"row_copy({mechanism})", PROBES)
    row_copy.launches += 1
    return out


row_copy.launches = 0


def dsmem_gather_reference(table, rows, cols) -> torch.Tensor:
    """Plain K8b: ``table.flat[rows * 512 + cols]``, clamped to the table."""
    r = rows.clamp(0, TH - 1).long()
    c = cols.clamp(0, TW - 1).long()
    return table.reshape(-1)[r * TW + c]


def dsmem_split(n: int, offsets: tuple) -> tuple:
    """K8b's split of n queries, as ``cprt_dsmem_gather`` makes it from
    the byte offsets modulo 16 of rows, cols and out: (head, body, tail),
    a scalar head that aligns the three to 16 bytes (all of n where their
    offsets differ), a ``VEC``-wide body and a scalar tail."""
    off = offsets[0] % 16
    if any(o % 16 != off for o in offsets):
        return n, 0, 0
    head = min(n, (16 - off) % 16 // 4)
    body = (n - head) // VEC * VEC
    return head, body, n - head - body


def dsmem_gather(table, rows, cols) -> torch.Tensor:
    """K8b wrapper: texels of a (256, 512) f32 table at int32 rows, cols."""
    if rows.device.type == "cpu":
        return dsmem_gather_reference(table, rows, cols)
    if rows.device.type != "cuda":
        raise ValueError(f"dsmem_gather: unsupported device {rows.device}")
    if table.shape != (TH, TW) or table.dtype != torch.float32 \
            or not table.is_contiguous() or table.data_ptr() % 16 \
            or table.device != rows.device or cols.shape != rows.shape \
            or rows.dtype != torch.int32 or cols.dtype != torch.int32 \
            or not (rows.is_contiguous() and cols.is_contiguous()) \
            or cols.device != rows.device:
        raise ValueError(f"dsmem_gather: table {tuple(table.shape)} "
                         f"{table.dtype}, rows {tuple(rows.shape)} "
                         f"{rows.dtype}, cols {tuple(cols.shape)} {cols.dtype}")
    n = rows.numel()
    # out shares rows' offset modulo 16 bytes, so a view of rows and cols
    # that starts off 16 bytes still takes the vector body
    buf = torch.empty(n + 3, dtype=torch.float32, device=rows.device)
    skip = (rows.data_ptr() - buf.data_ptr()) % 16 // 4
    out = buf[skip:skip + n].view(rows.shape)
    if n == 0:
        return out
    err = load_library(PROBES).cprt_dsmem_gather(
        table.data_ptr(), rows.data_ptr(), cols.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    check(err, "dsmem_gather", PROBES)
    dsmem_gather.launches += 1
    return out


dsmem_gather.launches = 0


def _line(name: str, ms: float, where: str) -> None:
    print(f"{name:44s} {ms:9.4f} ms{where}", flush=True)


def p1_stream_overlap(device, width: int = W, height: int = H,
                      iters: int = 50) -> dict:
    """Kernel A and the texel gather alone, together on two streams, and a
    trivial launch."""
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
    from cpuperformanceraytracer_tpu_torch.kernels.env_gather import gather_texels
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes,
    )
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

    cuda = device.type == "cuda"
    cfg = RenderConfig(width=width, height=height, spp=1, bounces=8,
                       scene="glass_spheres", env_mode="none", rng="wang",
                       backend="cuda" if cuda else "torch")
    scene, cam = scene_by_name(cfg.scene, device=device)
    tex = texture_from_array(gradient_sky(512, 256), device)
    # the real miss indices of a rendered frame: kernel B's index_out
    ecfg = cfg.replace(env_mode="equirect")
    planes = render_planes(pack_tables(scene, cam, ecfg, device), ecfg, 3)
    idx = torch.empty((height, width), dtype=torch.int64, device=device)
    env_accumulate(planes, tex, ecfg, torch.zeros((3, height, width),
                   device=device), 1.0, index_out=idx)
    rows, cols = (idx // tex.width).reshape(-1), (idx % tex.width).reshape(-1)
    tables = pack_tables(scene, cam, cfg, device)
    buf = torch.empty_like(planes)
    one = torch.zeros(1, device=device)

    def kernel():
        render_planes(tables, cfg, 3, out=buf)

    def gather():
        gather_texels(tex, rows, cols)

    if cuda:
        s_kernel, s_gather = torch.cuda.Stream(device), torch.cuda.Stream(device)

        def both():
            cur = torch.cuda.current_stream(device)
            s_kernel.wait_stream(cur)
            s_gather.wait_stream(cur)
            with torch.cuda.stream(s_kernel):
                kernel()
            with torch.cuda.stream(s_gather):
                gather()
            cur.wait_stream(s_kernel)
            cur.wait_stream(s_gather)
    else:
        def both():
            kernel()
            gather()

    where = "" if cuda else " (CPU host clock)"
    ms = {}
    for key, name, fn in (
            ("trivial", "P1 trivial launch (launch overhead)", lambda: one.add_(1.0)),
            ("kernel", "P1 kernel A alone (no-env fwd)", kernel),
            ("gather", f"P1 texel gather alone ({rows.numel()} queries)", gather),
            ("together", "P1 both, independent, two streams"
             if cuda else "P1 both, one after the other", both)):
        ms[key] = device_ms(fn, iters, device)
        _line(name, ms[key], where)
    overlap = ms["together"] < ms["kernel"] + ms["gather"]
    print(f"P1 raw: trivial {ms['trivial']:.4f} | kernel {ms['kernel']:.4f} | "
          f"gather {ms['gather']:.4f} | together {ms['together']:.4f} ms")
    print(f"P1 together < kernel + gather: {overlap} (together - kernel = "
          f"{ms['together'] - ms['kernel']:.4f} ms of the gather's "
          f"{ms['gather']:.4f})")
    return dict(ms=ms, overlap=overlap, queries=rows.numel())


def p2_row_copy_cost(device, seed: int = 0, iters: int = 8) -> dict:
    """ns per row copy, by mechanism, row size and copies in flight."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((TABLE_ROWS, 128), dtype=np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, TABLE_ROWS, max(COPIES),
                                        dtype=np.int32)).to(device)
    where = "" if device.type == "cuda" else " (CPU host clock)"
    ms, correct = {}, {}
    for row in ROW_FLOATS:
        tbl = table if row == table.shape[1] else table[:, :row].contiguous()
        for mech in MECHANISMS:
            for depth in DEPTHS:
                for n in COPIES:
                    key = (mech, row * 4, n, depth)
                    got = row_copy(tbl, idx[:n], mech, depth)
                    correct[key] = bool(torch.equal(
                        got, row_copy_reference(tbl, idx[:n])))
                    ms[key] = device_ms(lambda: row_copy(tbl, idx[:n], mech, depth),
                                        iters, device)
                    _line(f"P2 {n} {row * 4} B row copies, {mech}, depth {depth}",
                          ms[key], where)
                    print(f"P2   -> {ms[key] * 1e6 / n:.1f} ns/copy; correct: "
                          f"{correct[key]}")
                lo, hi = min(COPIES), max(COPIES)
                step = (ms[(mech, row * 4, hi, depth)]
                        - ms[(mech, row * 4, lo, depth)]) * 1e6 / (hi - lo)
                print(f"P2 {mech} {row * 4} B rows, depth {depth}: {step:.1f} ns "
                      f"per added copy (the launch taken out)")
    return dict(ms=ms, correct=correct, table=table, idx=idx)


def p3_dsmem_gather(device, seed: int = 0, iters: int = 100) -> dict:
    """The cluster gather at (16, 128) and 921600 queries, and K7 and
    torch indexing (both through L2) beside."""
    from cpuperformanceraytracer_tpu_torch.probes.gather_bench import (
        bench_inputs,
        texel_gather,
    )

    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((TH, TW), dtype=np.float32)).to(device)
    small = [torch.from_numpy(rng.integers(0, hi, (16, 128), dtype=np.int32)).to(device)
             for hi in (TH, TW)]
    _, rows_n, cols_n = bench_inputs(seed)
    big = [torch.from_numpy(a).to(device) for a in (rows_n, cols_n)]
    flat = big[0] * TW + big[1]
    where = "" if device.type == "cuda" else " (CPU host clock)"
    ms, correct = {}, {}
    for key, (rows, cols) in (("16x128", small), ("921600", big)):
        got = dsmem_gather(table, rows, cols)
        correct[key] = bool(torch.equal(got, dsmem_gather_reference(table, rows, cols)))
        ms[key] = device_ms(lambda: dsmem_gather(table, rows, cols), iters, device)
        _line(f"P3 DSMEM gather, cluster of {CLUSTER}, {rows.numel()} q",
              ms[key], where)
        print(f"   correct: {correct[key]}")
        r64, c64 = rows.long(), cols.long()
        ms[f"index_{key}"] = device_ms(lambda: table[r64, c64], iters, device)
        _line(f"P3 table[rows, cols] (L2), {rows.numel()} q", ms[f"index_{key}"], where)
    # the same launch with every query at texel (0, 0): the staging, the
    # index and output bytes and one DSMEM address a warp; the difference
    # to the uniform queries is the cost of their scattered remote reads
    zero = torch.zeros_like(big[0])
    ms["921600_same_texel"] = device_ms(lambda: dsmem_gather(table, zero, zero),
                                        iters, device)
    _line(f"P3 DSMEM gather, every query at texel (0, 0), {zero.numel()} q",
          ms["921600_same_texel"], where)
    l2 = table.reshape(1, -1)
    ms["l2_921600"] = device_ms(lambda: texel_gather(l2, flat), iters, device)
    _line(f"P3 L2 gather (K7 planar), {flat.numel()} q", ms["l2_921600"], where)
    return dict(ms=ms, correct=correct, table=table, small=small, big=big)


def run(device, which: str = "all", width: int = W, height: int = H,
        seed: int = 0) -> dict:
    device = torch.device(device)
    out = {}
    if which in ("p1", "all"):
        out["p1"] = p1_stream_overlap(device, width, height)
    if which in ("p2", "all"):
        out["p2"] = p2_row_copy_cost(device, seed)
    if which in ("p3", "all"):
        out["p3"] = p3_dsmem_gather(device, seed)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", nargs="?", default="all",
                   choices=["p1", "p2", "p3", "all"])
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--width", type=int, default=W, help="P1's frame")
    p.add_argument("--height", type=int, default=H, help="P1's frame")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    run(resolve_device(a.backend), a.which, a.width, a.height, a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
