"""Build and load the port's CUDA kernels.

Two libraries, each built the same way: ``RENDER`` from ``csrc/*.cu``
(the kernels of the render and training paths) and ``PROBES`` from
``csrc/probes/*.cu`` (the probe kernels), so a probe source that fails to
compile never touches the main paths, and the render library's name and
build time do not depend on the probes. Every ``.cu`` file of a library
is compiled by its own ``nvcc`` (all started together), and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds). Each pointer
and the stream pass as ``c_void_p``; every C entry point returns the
``cudaError_t`` of its launch, which ``check`` turns into an exception.

A library goes to ``<repo>/build/kernels/`` (``build/`` is listed in
``.gitignore``), named by a hash of its sources, headers and flags, and
is built at its first use in a process. Nothing is compiled at import
time.

Flags: ``sm_90a``, ``-O3``, ``--fmad=false`` and no ``--use_fast_math``
(the default ``-prec-div=true -prec-sqrt=true`` stay): the parity policy
of the JAX reference, exact division and sqrt and no FMA contraction.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "cprt_render_planes": [
        _P, _I, _P, _I, _P, _I, _P,      # tables and their row counts
        _P,                               # out (12, local_height, W)
        _I, _I, _I, _I,                   # width height row0 local_height
        _I, _I, _I, _I,                   # frame sample0 spp bounces
        _I, _I, _I, _I, _I, _I,           # counter env_draws env_none roulette zangle jitter
        _F, _F,                           # aspect inv_spp
        _P, _P,                           # work counter (1 int32), lane stats (2 u64, nullable)
        _P, _I,                           # frame base (1 int32, nullable), resident grid
        _P,                               # stream
    ],
    "cprt_render_planes_resident": [
        _I, _I, _I, _P, _P,               # NQ NS NM, out: blocks per SM, SMs
    ],
    "cprt_env_accumulate": [
        _P, _I,                           # planes (12, H, W), H*W
        _P, _P, _P, _I, _I,               # texture r g b, width, height
        _P, _F,                           # accum (3, H, W), blend
        _I, _I, _I, _I,                   # env cubemap stochastic flip
        _P,                               # index_out (nullable)
        _P,                               # stream
    ],
    "cprt_bwd_tables": [
        _P, _I, _P, _I, _P, _I, _P,      # tables and their row counts
        _P, _P, _I,                       # cot6 (6, local_height, W), partials, blocks
        _I, _I, _I, _I,                   # width height row0 local_height
        _I, _I, _I,                       # frame sample0 bounces
        _I, _I, _I, _I, _I,               # env_draws env_none roulette zangle jitter
        _F,                               # aspect
        _P,                               # lane stats (2 u64, nullable)
        _P,                               # frame base (1 int32, nullable)
        _P,                               # stream
    ],
    "cprt_bwd_tables_blocks": [
        _I, _I, _I, _I, _I, _I, _P,      # NQ NS NM bounces width height, out: blocks
    ],
    "cprt_env_backward_runs": [
        _P, _P, _P,                       # g (3, n), idx (n,) int64, mt (3, n)
        _P, _P, _P,                       # texture r g b
        _P,                               # cot_mt (3, n)
        _P, _P,                           # run keys (m,) int32, records (m, 4)
        _P, _P, _P,                       # d_r d_g d_b (zeroed)
        _I, _I,                           # n, T
        _P,                               # stream
    ],
    "cprt_env_backward_sums": [
        _P, _P, _P,                       # sorted keys (m,), their slots int64, records
        _I, _I,                           # m, T
        _P, _P, _P,                       # d_r d_g d_b
        _P,                               # stream
    ],
    "cprt_env_lookup": [
        _P, _I,                           # planes (12, H, W), H*W
        _P, _P, _P, _I, _I,               # texture r g b, width, height
        _I, _I, _I,                       # cubemap sampling flip
        _P, _P,                           # out (P, 4), taps (P, 4) int64 (nullable)
        _P,                               # stream
    ],
    "cprt_gather_texels": [
        _P, _P, _P, _I, _I,               # texture r g b, width, height
        _P, _P, _I, _I,                   # rows, cols, int64 indices?, n
        _P,                               # out (n, 4)
        _P,                               # stream
    ],
    "cprt_combine": [
        _P, _L,                           # e4, its sample stride (floats)
        _P, _L,                           # rgb, its sample stride
        _P, _L,                           # thr, its sample stride
        _P, _I, _I,                       # accum (3, H, W), H*W, spp
        _F, _F,                           # inv_spp blend
        _P,                               # stream
    ],
    "cprt_adam": [
        _P, _I,                           # leaves (n, 6) int64 on the host, n
        _F, _F, _F, _F, _F, _F, _F,       # 1/lr beta1 beta2 1-beta1 1-beta2 eps wd
        _I,                               # maximize
        _P,                               # stream
    ],
    "cprt_deflate": [
        _P, _P, _I,                       # in (bytes), jobs (slices, 4), slices
        _P, _I,                           # members (members, 3), members
        _P, _P, _P, _P,                   # tokens slots out_len crcs (scratch)
        _P, _P,                           # packed, member_out (members, 2)
        _P,                               # stream
    ],
    "cprt_tonemap": [
        _P, _P, _I, _F,                   # in, out (3, H, W), 3*H*W, exposure
        _P,                               # stream
    ],
}
_PROBE_SIGNATURES = {
    "cprt_trace_dots": [
        _P, _P, _P, _I, _I,               # x (8, n), B (54, 8), out, n, unit (0-2)
        _P,                               # stream
    ],
    "cprt_texel_gather": [
        _P, _I, _I,                       # table, entries, planes (0: packed (N, 4))
        _P, _I, _P,                       # idx (n,) int32, n, out
        _P,                               # stream
    ],
    "cprt_row_copy": [
        _P, _I, _I,                       # table, its rows, floats a row
        _P, _I, _P, _I,                   # idx (n,) int32, n, out (8, row), tma?
        _I,                               # depth: copies in flight, 1..8
        _P,                               # stream
    ],
    "cprt_dsmem_gather": [
        _P, _P, _P, _I, _P,               # table (256, 512), rows, cols, n, out
        _P,                               # stream
    ],
}


@dataclass(frozen=True, eq=False)
class Library:
    name: str          # the .so file's stem, before the hash
    src_dir: Path      # its sources: src_dir/*.cu and src_dir/*.cuh
    signatures: tuple  # (C entry point, ctypes argument types) pairs


RENDER = Library("cprt_kernels", CSRC_DIR, tuple(_SIGNATURES.items()))
PROBES = Library("cprt_probes", CSRC_DIR / "probes",
                 tuple(_PROBE_SIGNATURES.items()))


@dataclass(frozen=True)
class Build:
    path: Path
    log: str          # nvcc's output (ptxas register and spill report)
    seconds: float    # 0.0 when the library was already built


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def build(lib: Library = RENDER) -> Build:
    """Compile a library unless a build of these exact sources exists."""
    sources = sorted(lib.src_dir.glob("*.cu"))
    digest = hashlib.sha1()
    for p in sources + sorted(lib.src_dir.glob("*.cuh")):
        digest.update(p.name.encode() + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"lib{lib.name}_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return Build(path, "", 0.0)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [tmp / f"{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [f"{src.name} ({proc.returncode}):\n{log}"
              for src, proc, log in zip(sources, procs, logs) if proc.returncode]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    so = tmp / path.name
    link = subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    os.replace(so, path)
    shutil.rmtree(tmp, ignore_errors=True)
    return Build(path, "".join(logs), time.perf_counter() - t0)


@functools.lru_cache(maxsize=None)
def load_library(lib: Library = RENDER) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build(lib).path))
    for name, argtypes in lib.signatures:
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    dll.cprt_error_string.argtypes = [ctypes.c_int]
    dll.cprt_error_string.restype = ctypes.c_char_p
    return dll


def check(err: int, what: str, lib: Library = RENDER) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = load_library(lib).cprt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")
