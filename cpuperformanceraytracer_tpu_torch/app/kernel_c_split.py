"""Split the time of a one-thread-per-pixel kernel C with clock64 counters.

    python -m cpuperformanceraytracer_tpu_torch.app.kernel_c_split \\
        --tree build/parent --out out/kernel_c_split

For a checkout whose ``csrc/backward.cu`` runs kernel C as one thread per
pixel (``pixel_adjoint``: a replay loop of ``bounce``, a stack of segment
states in local memory, a reverse loop of ``segment`` and
``segment_adjoint``, shared atomics, a partials row per block). The
script copies that tree's ``csrc/``, inserts clock64 counters into its
kernel C by exact text substitutions (it stops if one does not match),
builds it alone with the port's nvcc flags and launches it at the
training step's shapes: 1280x720 glass_spheres, 8 bounces, counter RNG,
frame 1, a seeded cotangent. Each thread adds the cycles of every part to
the totals:

- replay: ``bounce`` in the forward replay;
- reverse: ``segment`` again in the reverse sweep;
- adjoint: ``segment_adjoint``, less the atomics inside it;
- atomics: the shared atomics (timed one by one);
- stack: the stores and loads of the segment states;
- rows_out: the partials write of the block;

and the whole pixel (camera ray and camera adjoint included). Prints one
JSON line with each part's share of the thread-cycles, the instrumented
kernel's time (stream held full; ``app/kernel_ab.py`` times the tree's
own kernel) and the card's nvidia-smi line; also written to
``<out>/split.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

PARTS = ("replay", "reverse", "adjoint", "atomics", "stack", "rows_out", "all")

# (text of the one-thread-per-pixel kernel C, its instrumented form)
PATCHES = (
    ("""struct SharedAcc {
    float* cells;
    __device__ __forceinline__ void operator()(int cell, float v) {
        if (v != 0.0f) atomicAdd(&cells[cell], v);
    }
};""", """struct SharedAcc {
    float* cells;
    long long* clk;
    __device__ __forceinline__ void operator()(int cell, float v) {
        const long long t0 = clock64();
        if (v != 0.0f) atomicAdd(&cells[cell], v);
        clk[3] += clock64() - t0;
    }
};"""),
    ("""                          const Cells& C, int col, int row, const float* cot, Acc& acc) {""",
     """                          const Cells& C, int col, int row, const float* cot, Acc& acc,
                          long long* clk) {
    long long t0;"""),
    ("""        st_thr[seg] = p.thr;
        st_pos[seg] = p.pos;
        st_dir[seg] = p.dir;
        bounce(p, rng, P, quads, sph, inv_r, mats, cam);""",
     """        t0 = clock64();
        st_thr[seg] = p.thr;
        st_pos[seg] = p.pos;
        st_dir[seg] = p.dir;
        clk[4] += clock64() - t0;
        t0 = clock64();
        bounce(p, rng, P, quads, sph, inv_r, mats, cam);
        clk[0] += clock64() - t0;"""),
    ("""        q.thr = st_thr[seg];
        q.pos = st_pos[seg];
        q.dir = st_dir[seg];""",
     """        t0 = clock64();
        q.thr = st_thr[seg];
        q.pos = st_pos[seg];
        q.dir = st_dir[seg];
        clk[4] += clock64() - t0;"""),
    ("""        segment(q, rng, P, quads, sph, inv_r, mats, cam, s);
        segment_adjoint(q, s, P, quads, sph, inv_r, cam, C, a, acc);""",
     """        t0 = clock64();
        segment(q, rng, P, quads, sph, inv_r, mats, cam, s);
        clk[1] += clock64() - t0;
        const long long t_atom = clk[3];
        t0 = clock64();
        segment_adjoint(q, s, P, quads, sph, inv_r, cam, C, a, acc);
        clk[2] += clock64() - t0 - (clk[3] - t_atom);"""),
    ("""                  float* __restrict__ partials) {""",
     """                  float* __restrict__ partials, unsigned long long* clocks) {
    long long clk[7] = {};"""),
    ("""        SharedAcc acc{cells};
        pixel_adjoint(P, S.quads, S.sph, S.inv_r, S.mats, S.cam, C, col, row, cot, acc);""",
     """        SharedAcc acc{cells, clk};
        const long long t_all = clock64();
        pixel_adjoint(P, S.quads, S.sph, S.inv_r, S.mats, S.cam, C, col, row, cot, acc, clk);
        clk[6] += clock64() - t_all;"""),
    ("""    for (int i = tid; i < C.n; i += nthreads) out[i] = cells[i];
}""", """    const long long t_out = clock64();
    for (int i = tid; i < C.n; i += nthreads) out[i] = cells[i];
    clk[5] += clock64() - t_out;
    clk[6] += clk[5];
    for (int i = 0; i < 7; ++i) atomicAdd(&clocks[i], (unsigned long long)clk[i]);
}"""),
    ("""                               float aspect, void* stream) {""",
     """                               float aspect, unsigned long long* clocks, void* stream) {"""),
    ("""        P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, cot6, partials);""",
     """        P, quad_tbl, sph_tbl, mat_tbl, cam_tbl, cot6, partials, clocks);"""),
)


def instrument(src: str) -> str:
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"kernel_c_split: this tree's backward.cu is not the "
                             f"one-thread-per-pixel kernel C (no match for:\n{old})")
        src = src.replace(old, new)
    return src


def build(tree: Path, out_dir: Path) -> ctypes.CDLL:
    from cpuperformanceraytracer_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc

    csrc = tree / "cpuperformanceraytracer_tpu_torch" / "csrc"
    work = out_dir / "csrc"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for p in csrc.glob("*.cuh"):
        shutil.copy(p, work / p.name)
    (work / "backward.cu").write_text(instrument((csrc / "backward.cu").read_text()))
    so = out_dir / "libkernel_c_split.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                           str(work / "backward.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cprt_bwd_tables.argtypes = [P, I, P, I, P, I, P, P, P] + [I] * 10 + [F, P, P]
    lib.cprt_bwd_tables.restype = I
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_c_split")
    ap.add_argument("--tree", required=True,
                    help="a checkout with the one-thread-per-pixel kernel C")
    ap.add_argument("--out", default="build/kernel_c_split")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_c_split: no CUDA GPU available", file=sys.stderr)
        return 1
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        _ROULETTE,
        _aspect,
        pack_tables,
    )
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_ms

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    lib = build(Path(a.tree), out)
    dev = torch.device("cuda")
    cfg = RenderConfig(width=1280, height=720, bounces=8, spp=1, rng="counter",
                       scene="glass_spheres", env_mode="equirect",
                       env_sampling="stochastic")
    tables = pack_tables(*scene_by_name(cfg.scene, device=dev), cfg, dev)
    cot6 = torch.randn((6, 720, 1280), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    blocks = ((1280 + 31) // 32) * ((720 + 3) // 4)
    partials = torch.empty((blocks, sum(t.numel() for t in tables)), device=dev)
    clocks = torch.zeros(len(PARTS), dtype=torch.int64, device=dev)
    q, s, m, c = tables

    def launch(clk):
        err = lib.cprt_bwd_tables(
            q.data_ptr(), q.shape[0], s.data_ptr(), s.shape[0], m.data_ptr(),
            m.shape[0], c.data_ptr(), cot6.data_ptr(), partials.data_ptr(),
            cfg.width, cfg.height, 1, 0, cfg.bounces, 1, 0,
            _ROULETTE[cfg.roulette], int(cfg.unit_vector_sampler == "zangle"),
            int(cfg.jitter), ctypes.c_float(_aspect(cfg)),
            clk, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel_c_split: launch failed ({err})")

    launch(clocks.data_ptr())
    torch.cuda.synchronize()
    totals = clocks.tolist()
    res = {"tree": a.tree, "split": {k: v / totals[-1] for k, v in zip(PARTS, totals)},
           "thread_cycles": dict(zip(PARTS, totals)),
           "instrumented_ms": device_ms(lambda: launch(clocks.data_ptr()), 10, dev)}
    res["gpu"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True, timeout=60).stdout.strip()
    line = json.dumps(res)
    print(line)
    (out / "split.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
