"""The checkpoint's deflate (``kernels/deflate.py``, ``csrc/deflate.cu``)
on the CPU.

The plain version's streams inflate with zlib back to their members
(zeros, random bytes, a rendered accumulator's float planes, at slice
boundaries and ragged tails), its code lengths stay within deflate's
limits where a plain Huffman code would not, and its CRC-32s are zlib's.
The kernel's source, compiled by the host C++ compiler and run with a
thread for each CUDA thread, makes the plain version's bytes and CRCs.
An archive written through the plain version reads back bit-equal.
"""

import ctypes
import dataclasses
import json
import shutil
import subprocess
import zipfile
import zlib

import numpy as np
import pytest
import torch

from benchmark.harness import check
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.io import checkpoint as ckpt
from cpuperformanceraytracer_tpu_torch.kernels import deflate as dfl

SLICE = dfl.SLICE


def _inflate(stream) -> bytes:
    z = zlib.decompressobj(-15)
    out = z.decompress(bytes(stream)) + z.flush()
    assert z.eof and not z.unused_data
    return out


def _floats(n: int, seed: int = 0) -> np.ndarray:
    """``n`` bytes of a float32 accumulator-like plane: a smooth image and
    the noise of a few hundred samples a pixel."""
    rng = np.random.default_rng(seed)
    count = -(-n // 4)
    x = np.linspace(0, 6, count)
    plane = (0.4 + 0.3 * np.sin(x) + 0.02 * rng.standard_normal(count))
    return plane.astype(np.float32).view(np.uint8)[:n].copy()


def _data(kind: str, n: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "random":
        return np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    return _floats(n, n)


@pytest.mark.parametrize("kind", ["zeros", "random", "floats"])
@pytest.mark.parametrize("n", [0, 1, SLICE - 1, SLICE, SLICE + 1, 65535,
                               65536, 65537, 3 * SLICE + 1234],
                         ids=["0", "1", "slice-1", "slice", "slice+1",
                              "65535", "65536", "65537", "slices+tail"])
def test_plain_streams_inflate_to_their_members(kind, n):
    data = _data(kind, n)
    (stream, crc), = dfl.deflate_reference(data, [n])
    assert _inflate(stream) == data.tobytes()
    assert crc == zlib.crc32(data)
    # a slice's output fits its slot, stored framing at most
    assert len(stream) <= n + 5 * max(-(-n // SLICE), 1)
    if kind == "zeros" and n > 1000:
        assert len(stream) < n // 50


def test_members_end_to_end_and_crcs_from_a_header():
    head = b"\x93NUMPY\x01\x00v\x00{'descr': '<f4'}" + b" " * 20 + b"\n"
    sizes = [SLICE + 5, 0, 1, 2 * SLICE]
    data = np.concatenate([_floats(s, i) for i, s in enumerate(sizes)])
    starts = [zlib.crc32(head)] * len(sizes)
    got = dfl.deflate_reference(data, sizes, starts)
    at = 0
    for (stream, crc), size in zip(got, sizes):
        body = data[at:at + size].tobytes()
        at += size
        assert _inflate(stream) == body
        assert crc == zlib.crc32(head + body)
    assert got[1][0] == dfl.EMPTY


def test_code_lengths_are_limited_where_huffman_runs_deeper():
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    freq = fib + [0] * (286 - len(fib))
    lengths = dfl._code_lengths(freq, 15)
    used = [n for n in lengths if n]
    assert len(used) == 40 and max(used) == 15
    assert sum(2.0 ** -n for n in used) == 1.0      # a complete code
    # the more frequent symbol never has the longer code
    pairs = sorted(zip(freq[:40], lengths[:40]))
    assert all(a[1] >= b[1] for a, b in zip(pairs, pairs[1:]))
    assert max(dfl._code_lengths(fib[:19], 7)) == 7
    # a stream whose literals follow the same counts
    data = np.repeat(np.arange(24, dtype=np.uint8), fib[:24])
    np.random.default_rng(0).shuffle(data)
    (stream, _), = dfl.deflate_reference(data, [len(data)])
    assert _inflate(stream) == data.tobytes()


def test_one_symbol_and_none():
    assert dfl._code_lengths([0, 0, 5] + [0] * 27, 15)[:3] == [1, 0, 1]
    assert dfl._code_lengths([0] * 30, 15)[:2] == [1, 1]


def test_the_wrapper_routes_by_device():
    data = torch.from_numpy(_floats(SLICE + 3))
    before = dfl.deflate.launches
    (stream, crc), = dfl.deflate(data, [data.numel()]).fetch()
    assert dfl.deflate.launches == before       # the CPU launches nothing
    assert _inflate(stream) == data.numpy().tobytes()
    assert crc == zlib.crc32(data.numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        dfl.deflate(data.to("meta"), [data.numel()])
    with pytest.raises(ValueError):
        dfl.deflate(data, [data.numel() - 1])
    with pytest.raises(ValueError):
        dfl.deflate(data.view(torch.int8), [data.numel()])


def test_an_archive_through_the_plain_version_reads_back(tmp_path):
    """The card's route of a save, with the plain version in the kernel's
    place: the file reads back bit-equal by ``numpy.load``, passes the
    benchmark's check of a save and ``zipfile``'s of every CRC. (Its size
    against numpy's is held on the card, at 4K.)"""
    acc = np.stack([_floats(4 * 48 * 160, c).view(np.float32).reshape(48, 160)
                    for c in range(3)])
    cfg = RenderConfig(width=160, height=48, spp=1, bounces=2, rng="counter")
    path = tmp_path / "c.npz"
    entries = ckpt._kernel_entries(torch.from_numpy(acc), 12, cfg)
    with open(path, "wb") as f:
        ckpt._write_zip(f, entries)
    with np.load(path, allow_pickle=False) as z:
        for c, plane in zip("rgb", acc):
            assert np.array_equal(z[c].view(np.uint32), plane.view(np.uint32))
    opts = {k: getattr(cfg, k) for k in check.SAVE_CONFIG_KEYS}
    assert check.save_fault(path, torch.from_numpy(acc), 12,
                            ckpt.FORMAT_VERSION, opts) is None
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None          # every member's CRC read back


# ---- the kernel's source on the host ---------------------------------------
#
# csrc/deflate.cu is plain C++ outside its CUDA-only parts; this harness
# gives it the built-ins it uses (a block of threads with barriers for
# __syncthreads and __syncwarp, __match_any_sync through a warp's scratch,
# atomics) and runs its kernels as cprt_deflate launches them.

HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct Dim3 { unsigned x = 0, y = 1, z = 1; };
static thread_local Dim3 threadIdx, blockIdx;
static Dim3 blockDim, gridDim;
static std::unique_ptr<std::barrier<>> block_barrier;
static std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
static std::vector<unsigned> warp_values;
static std::vector<unsigned char> host_smem;

#define __global__
#define __launch_bounds__(...)
#define __restrict__
#define DFL_DEV inline
#define DFL_CONST static const
#define DFL_SMEM(p) unsigned char* p = host_smem.data()

inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
    warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
inline unsigned __match_any_sync(unsigned, unsigned v) {
    const unsigned w = threadIdx.x / 32 * 32;
    warp_values[threadIdx.x] = v;
    __syncwarp();
    unsigned m = 0;
    for (unsigned i = 0; i < 32; ++i) m |= (unsigned)(warp_values[w + i] == v) << i;
    __syncwarp();
    return m;
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __brev(unsigned x) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
    return r;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicOr(unsigned* p, unsigned v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }

#include "deflate.cu"

static void launch(int grid, int block, int smem, const std::function<void()>& body) {
    gridDim.x = grid;
    blockDim.x = block;
    for (int b = 0; b < grid; ++b) {
        host_smem.assign(smem > 0 ? smem : 1, 0xA5);   // garbage, as on the card
        block_barrier = std::make_unique<std::barrier<>>(block);
        warp_barriers.clear();
        for (int w = 0; w < (block + 31) / 32; ++w)
            warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
        warp_values.assign(block, 0);
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
            threads.emplace_back([t, b, &body] {
                threadIdx.x = t;
                blockIdx.x = b;
                body();
            });
        for (auto& th : threads) th.join();
    }
}

extern "C" int host_deflate(const uint8_t* in, const long long* jobs, int n_slices,
                            const long long* members, int n_members, uint32_t* tokens,
                            uint8_t* slots, int* out_len, uint32_t* crcs, uint8_t* packed,
                            long long* member_out) {
    using namespace dfl;
    launch(n_slices, THREADS, SMEM_BYTES,
           [&] { slices_kernel(in, jobs, tokens, slots, out_len, crcs); });
    launch(n_slices, THREADS, PACK_SMEM, [&] { pack_kernel(slots, out_len, packed); });
    launch(1, FINISH_THREADS, FINISH_SMEM,
           [&] { finish_kernel(jobs, members, n_members, out_len, crcs, member_out); });
    return SMEM_BYTES;
}
"""


@pytest.fixture(scope="module")
def host_deflate(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    from cpuperformanceraytracer_tpu_torch.kernels._build import CSRC_DIR

    d = tmp_path_factory.mktemp("host_deflate")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    f"-I{CSRC_DIR}", "-x", "c++", str(d / "harness.cpp"),
                    "-o", str(d / "libharness.so")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_deflate.argtypes = [P, P, I, P, I, P, P, P, P, P, P]
    lib.host_deflate.restype = I

    def run(data: np.ndarray, sizes, starts):
        jobs, members = dfl.plan(sizes, starts)
        n = len(jobs)
        tokens = np.zeros(max(n, 1) * SLICE, np.uint32)
        slots = np.zeros(max(n, 1) * dfl.SLOT, np.uint8)
        out_len = np.zeros(max(n, 1), np.int32)
        crcs = np.zeros(max(n, 1), np.uint32)
        packed = np.zeros(max(n, 1) * dfl.SLOT, np.uint8)
        out = np.zeros((max(len(sizes), 1), 2), np.int64)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        smem = lib.host_deflate(ptr(data), ptr(jobs), n, ptr(members),
                                len(sizes), ptr(tokens), ptr(slots),
                                ptr(out_len), ptr(crcs), ptr(packed), ptr(out))
        assert smem <= 232448       # an H100 block's shared memory
        streams, at = [], 0
        for size, crc in out[:len(sizes)].tolist():
            streams.append((packed[at:at + size].tobytes() or dfl.EMPTY, crc))
            at += size
        return streams

    return run


@pytest.mark.parametrize("case", ["floats_and_ragged", "zeros_random_tiny"])
def test_kernel_source_matches_plain_on_host(host_deflate, case):
    if case == "floats_and_ragged":
        sizes = [2 * SLICE + 777, SLICE]
        data = np.concatenate([_floats(sizes[0], 3), _floats(sizes[1], 4)])
    else:
        sizes = [SLICE + 1, 0, 1, 3000, SLICE + 2, SLICE + 3]
        data = np.concatenate([np.zeros(sizes[0], np.uint8),
                               np.array([9], np.uint8),
                               _data("random", 3000),
                               _floats(SLICE + 2, 5), _floats(SLICE + 3, 6)])
    starts = [zlib.crc32(b"header"), 0, 12345, 0xFFFFFFFF, 1, 2][:len(sizes)]
    got = host_deflate(data, sizes, starts)
    want = dfl.deflate_reference(data, sizes, starts)
    for (g, gc), (w, wc) in zip(got, want):
        assert gc == wc
        assert g == w


def test_the_library_declares_the_entry_point_as_the_source_does():
    """ctypes passes as many arguments as ``_build`` declares for
    ``cprt_deflate``; the source's C function must take that many."""
    from cpuperformanceraytracer_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "deflate.cu").read_text()
    params = src.split('extern "C" int cprt_deflate(', 1)[1].split(")", 1)[0]
    declared = dict(_build.RENDER.signatures)["cprt_deflate"]
    assert len(declared) == params.count(",") + 1
