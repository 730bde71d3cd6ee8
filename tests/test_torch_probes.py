"""The probes' plain versions (K6-K8) vs the JAX probe scripts and their
contracts, on the CPU.

- K6 (``probes.trace_probe``): ``trace_dots_reference`` vs the script's
  own ``kernel_vpu`` and ``kernel_mxu`` (``scripts/mxu_trace_probe.py``,
  loaded from its path) through ``pl.pallas_call(..., interpret=True)``
  on one (8, 256) block of the script's input, max relative error (the
  script's metric, max |a - b| / max |b|) under 1e-5; and a plain
  emulation of the tensor-core kernel's 3xTF32 split (TF32 rounding by
  mantissa mask, as ``cvt.rna.tf32.f32``) within 1e-5 of the plain
  version, where one TF32 pass is not.
- K7, K8a, K8b: ``gather_bench.py`` runs its race at import and the
  overlap probe's kernels are closures, so none can be imported; the
  plain versions are held to the contracts with numpy and with eager
  ``jnp.take_along_axis`` (the Pallas bodies' own operation) on the same
  seeded inputs, bit for bit.
- K8a's ring of copies in flight and K8b's split of the queries into a
  scalar head, a vector body and a scalar tail, as Python models of the
  kernels' schedules.
- K6's wgmma unit: a Python model of its fragment maps (A, the
  accumulator, B's shared-memory tiles), of the quad sums and of the walk
  of a persistent grid over the tiles, written as the kernel indexes
  them, with the constants read from ``csrc/probes/trace_dots.cu``.
- K7's split of the queries into a scalar head, a 4-wide body and a
  scalar tail, and where its planar stores go 16 bytes at a time.
- The three probe entry points on the CPU (``--backend torch``).
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from cpuperformanceraytracer_tpu_torch.kernels import _build
from cpuperformanceraytracer_tpu_torch.probes import (
    gather_bench,
    overlap_probe,
    trace_probe,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"probe_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # builds B; nothing else runs
    return mod


@pytest.fixture(scope="module")
def trace_block():
    """One (8, 256) block of the script's input, its B, and the JAX
    kernels' outputs on it (each traced once: the VPU body is 9 x 54
    unrolled chains)."""
    m = _load_script("mxu_trace_probe")
    x_full, B = trace_probe.probe_inputs()
    np.testing.assert_array_equal(B, np.asarray(m.B))
    x = np.ascontiguousarray(x_full[:, :m.BH, :m.BW])
    outs = {}
    for name, kern in (("vpu", m.kernel_vpu), ("mxu", m.kernel_mxu)):
        call = pl.pallas_call(
            kern, grid=(1, 1),
            out_shape=jax.ShapeDtypeStruct((m.BH, m.BW), jnp.float32),
            in_specs=[pl.BlockSpec((m.NF, m.BH, m.BW), lambda i, j: (0, i, j)),
                      pl.BlockSpec((m.NCOL, m.NF), lambda i, j: (0, 0))],
            out_specs=pl.BlockSpec((m.BH, m.BW), lambda i, j: (i, j)),
            interpret=True)
        outs[name] = np.array(call(jnp.asarray(x), m.B))
    return x, B, outs


def test_probe_constants_match_script(trace_block):
    m = _load_script("mxu_trace_probe")
    assert (trace_probe.H, trace_probe.W, trace_probe.NF, trace_probe.NCOL,
            trace_probe.REPEAT) == (m.H, m.W, m.NF, m.NCOL, m.REPEAT)


@pytest.mark.parametrize("body", ["vpu", "mxu"])
def test_trace_dots_reference_matches_jax(trace_block, body):
    x, B, outs = trace_block
    got = trace_probe.trace_dots(torch.from_numpy(x), torch.from_numpy(B))
    err = trace_probe.max_rel_err(got, torch.from_numpy(outs[body]))
    assert err < 1e-5, err


def _tf32(v):
    """cvt.rna.tf32.f32: 10 mantissa bits, nearest, ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _trace_dots_tf32(x, B, passes):
    """The tensor-core kernel's arithmetic in plain torch: every segment
    U = x^T B^T of TF32 parts, 3 passes (lo*hi + hi*lo + hi*hi) or 1."""
    def parts(v):
        hi = _tf32(v)
        return hi, _tf32(v - hi)

    f = x.reshape(8, -1).t().contiguous()            # (P, 8)
    bhi, blo = parts(B.t().contiguous())              # (8, 54)
    acc = torch.zeros(f.shape[0])
    for _ in range(trace_probe.REPEAT):
        fhi, flo = parts(f)
        u = fhi @ bhi
        if passes == 3:
            u = (flo @ bhi + fhi @ blo) + u
        acc = acc + u[:, 0] * u[:, 1] - u[:, 2]
        acc = acc + u[:, 3:].sum(1)
        f = torch.cat([(acc * 1e-6)[:, None], f[:, 1:]], 1)
    return acc.reshape(x.shape[1:])


def test_tensor_core_split_precision(trace_block):
    x, B, _ = trace_block
    x, B = torch.from_numpy(x), torch.from_numpy(B)
    want = trace_probe.trace_dots_reference(x, B)
    assert trace_probe.max_rel_err(_trace_dots_tf32(x, B, 3), want) < 1e-5
    # one TF32 pass keeps ~3 digits: the split is what makes it f32-like
    assert trace_probe.max_rel_err(_trace_dots_tf32(x, B, 1), want) > 1e-4


def test_tf32_rounding():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3])
    got = _tf32(v)
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2 ** -10           # a tie rounds away from zero
    assert got[2] == 1.0 + 2 ** -9
    assert got[3] == -(1.0 + 2 ** -10)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("unit", trace_probe.UNITS)
def test_trace_dots_units_on_the_cpu_run_the_plain_version(trace_block, unit):
    x, B, _ = trace_block
    x, B = torch.from_numpy(x[:, :2, :64].copy()), torch.from_numpy(B)
    assert torch.equal(trace_probe.trace_dots(x, B, unit),
                       trace_probe.trace_dots_reference(x, B))


@pytest.mark.parametrize("unit", ["mxu", "WGMMA", "tensor_cores", ""])
def test_trace_dots_rejects_an_unknown_unit(unit):
    with pytest.raises(ValueError, match="unit"):
        trace_probe.trace_dots(torch.zeros((8, 4, 16)), torch.zeros((54, 8)), unit)


def _trace_dots_source():
    return (_build.PROBES.src_dir / "trace_dots.cu").read_text()


def _wgmma_constants():
    """The wgmma unit's shape, as its source states it: warpgroups a
    block and pixels a tile (one tile in flight a warpgroup)."""
    src = _trace_dots_source()
    val = {name: int(re.search(rf"\b{name} = (\d+);", src).group(1))
           for name in ("WG_PER_BLOCK", "TILE")}
    assert "NPAD = 8 * NTILE" in src and "ND = NPAD / 2" in src
    return val["WG_PER_BLOCK"], val["TILE"]


def _wgmma_threads():
    """(warp, lane, g, t, r) of the 128 threads of a warpgroup, as the
    kernel derives them: rows r and r + 8 of a tile are its pixels."""
    for warp in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            yield warp, lane, g, t, 16 * warp + g


def _acc_cell(r, t, i):
    """Accumulator register d[i] of the thread: d[4j + e] (row r, column
    8j + 2t + e), d[4j + 2 + e] (row r + 8, the same column)."""
    j, w = divmod(i, 4)
    return r + 8 * (w >> 1), 8 * j + 2 * t + (w & 1)


def _a_cell(r, t, i):
    """A fragment register a[i]: a0 (r, k t), a1 (r + 8, t), a2 (r, t + 4),
    a3 (r + 8, t + 4), as load_fragment fills them."""
    return r + 8 * (i & 1), t + 4 * (i >> 1)


def test_wgmma_fragment_maps_cover_each_cell_once():
    _, tile = _wgmma_constants()
    npad, nd = 8 * ((trace_probe.NCOL + 7) // 8), 28
    assert (tile, npad) == (64, 56) and nd == npad // 2
    acc = np.zeros((tile, npad), np.int64)
    a = np.zeros((tile, trace_probe.NF), np.int64)
    for _, _, _, t, r in _wgmma_threads():
        for i in range(nd):
            acc[_acc_cell(r, t, i)] += 1
        for i in range(4):
            a[_a_cell(r, t, i)] += 1
    assert (acc == 1).all() and (a == 1).all()
    # feature 0 of rows r and r + 8 is a0, a1 of the t = 0 threads only:
    # the registers finish_segment rewrites
    for _, _, _, t, r in _wgmma_threads():
        zero = [i for i in range(4) if _a_cell(r, t, i)[1] == 0]
        assert zero == ([0, 1] if t == 0 else [])


def test_wgmma_quad_sums_and_u012():
    """Each quad sums columns 3..53 once for both its rows, never the zero
    columns 54, 55; the t = 0 lane, which keeps acc, holds U0, U1 itself
    (d[0], d[1]; d[2], d[3] for row r + 8) and takes U2 from the t = 1
    lane's d[0] (d[2]); feature 0 is re-split by _tf32's bit form."""
    ncol = trace_probe.NCOL
    for warp in range(4):
        for g in range(8):
            r = 16 * warp + g
            for half, base in ((0, 0), (8, 2)):
                cols = []
                for t in range(4):
                    for j in range(7):
                        for e in range(2):
                            col = 8 * j + 2 * t + e
                            if 3 <= col < ncol:          # the kernel's test
                                assert _acc_cell(r, t, 4 * j + base + e) == (r + half, col)
                                cols.append(col)
                assert sorted(cols) == list(range(3, ncol))
                assert _acc_cell(r, 0, base) == (r + half, 0)        # U0
                assert _acc_cell(r, 0, base + 1) == (r + half, 1)    # U1
                assert _acc_cell(r, 1, base) == (r + half, 2)        # U2, lane + 1
    src = _trace_dots_source()
    body = src[src.index("void finish_segment"):src.index("void load_fragment")]
    for want in ("__shfl_down_sync(full, d[0], 1)", "__shfl_down_sync(full, d[2], 1)",
                 "acc_a = acc_a + d[0] * d[1] - u2a;", "acc_b = acc_b + d[2] * d[3] - u2b;",
                 "__shfl_xor_sync(full, sa, 1)", "__shfl_xor_sync(full, sa, 2)"):
        assert want in body
    assert "return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;" in src


def test_wgmma_b_tile_is_the_core_matrix_layout():
    """B's (56, 8) K-major tile: b_offset puts each (column, feature) once
    in 448 floats; a core matrix is 8 columns x 16 bytes, the next one
    along K 128 bytes on (LBO), the next 8 columns 256 bytes on (SBO),
    the strides the descriptor states."""
    def b_offset(c, k):                      # as trace_dots.cu writes it
        return (c >> 3) * 64 + (k >> 2) * 32 + (c & 7) * 4 + (k & 3)

    src = _trace_dots_source()
    assert "return (c >> 3) * 64 + (k >> 2) * 32 + (c & 7) * 4 + (k & 3);" in src
    assert "((uint64_t)(128 >> 4) << 16)" in src and "((uint64_t)(256 >> 4) << 32)" in src
    offs = np.array([[b_offset(c, k) for k in range(8)] for c in range(56)])
    assert sorted(offs.ravel().tolist()) == list(range(56 * 8))
    for c in range(56):
        for k in range(8):
            byte = 4 * offs[c, k]
            assert byte == (c // 8) * 256 + (k // 4) * 128 + (c % 8) * 16 + (k % 4) * 4


def _wgmma_stores(n, grid):
    """How often the kernel stores each pixel: warpgroup w of block b
    walks tiles b * WG + w, + grid * WG, ...; in a tile the t = 0 lane
    stores rows r and r + 8, where the pixel is below n."""
    WG, tile = _wgmma_constants()
    in_tile = np.zeros(tile, np.int64)
    for _, _, _, t, r in _wgmma_threads():
        if t == 0:
            in_tile[[r, r + 8]] += 1
    assert (in_tile == 1).all()
    tiles = -(-n // tile)
    seen = np.zeros(n, np.int64)
    pix = np.arange(tile)
    for b in range(grid):
        for w in range(WG):
            for s in range(b * WG + w, tiles, grid * WG):
                p = s * tile + pix
                np.add.at(seen, p[p < n], 1)
    return seen


@pytest.mark.parametrize("n", [64 * 5, 64 * 8, 7 * 45, 720 * 1280])
def test_wgmma_tile_walk_stores_each_pixel_once(n):
    WG, tile = _wgmma_constants()
    want = -(-(-(-n // tile)) // WG)         # launch_wgmma's grid, before the cap
    for grid in sorted({1, 3, min(want, 132), want}):
        assert (_wgmma_stores(n, grid) == 1).all(), grid


def _race_inputs(seed=0):
    tex, rows, cols = gather_bench.bench_inputs(seed)
    flat = rows * gather_bench.W + cols
    return tex.reshape(-1, 3), rows, cols, flat


@pytest.mark.parametrize("seed", [0, 3])
def test_texel_gather_planar_matches_take_along_axis(seed):
    texf, _, _, flat = _race_inputs(seed)
    plane = np.ascontiguousarray(texf[:, 0])
    got = gather_bench.texel_gather(torch.from_numpy(plane)[None],
                                    torch.from_numpy(flat))[0].numpy()
    np.testing.assert_array_equal(got, plane[flat])
    # pallas_tga's body on its first (8, 256) block of the (3600, 256) indices
    idx2 = flat.reshape(-1, 256)[:8]
    tab = jnp.asarray(plane).reshape(1, -1)
    tga = jnp.take_along_axis(jnp.broadcast_to(tab, (8, tab.shape[1])),
                              jnp.asarray(idx2), axis=1)
    np.testing.assert_array_equal(got[:8 * 256].reshape(8, 256), np.asarray(tga))
    planes = torch.from_numpy(np.ascontiguousarray(texf.T))
    got3 = gather_bench.texel_gather(planes, torch.from_numpy(flat)).numpy()
    np.testing.assert_array_equal(got3, texf[flat].T)


def test_texel_gather_packed_and_clamped():
    texf, _, _, flat = _race_inputs(1)
    packed = np.concatenate([texf, np.full((len(texf), 1), 7.0, np.float32)], 1)
    idx = flat[:1000].copy()
    idx[:2] = [-4, 10 ** 7]
    got = gather_bench.texel_gather(torch.from_numpy(packed),
                                    torch.from_numpy(idx), packed=True).numpy()
    np.testing.assert_array_equal(got, packed[np.clip(idx, 0, len(texf) - 1)])


def test_gather_bench_inputs_distribution():
    tex, rows, cols = gather_bench.bench_inputs(0)
    assert tex.shape == (256, 512, 3) and tex.dtype == np.float32
    assert rows.shape == cols.shape == (1280 * 720,) and rows.dtype == np.int32
    assert rows.min() == 0 and rows.max() == 255
    assert cols.min() == 0 and cols.max() == 511
    assert 0.0 <= tex.min() and tex.max() < 1.0


def _texel_vec():
    """K7's queries a thread (the planar body's width), as its source
    states it."""
    src = (_build.PROBES.src_dir / "texel_gather.cu").read_text()
    return int(re.search(r"\bV = (\d+);", src).group(1))


def _texel_split(n, idx_offset):
    """K7's split of n queries, as ``cprt_texel_gather`` makes it from the
    byte offset of the indices modulo 16 (a planar out shares it): (head,
    body, tail), a scalar head that aligns them to 16 bytes, a V-wide body
    and a scalar tail."""
    head = min(n, (16 - idx_offset % 16) % 16 // 4)
    body = (n - head) // _texel_vec() * _texel_vec()
    return head, body, n - head - body


def _texel_cover(n, idx_offset, planes=3):
    """How often K7's planar kernel stores each (plane, query), and
    whether every 16-byte store is aligned: the grid has a thread for each
    4-query chunk of the body (and at least one for each head query),
    rounded up to blocks of 256; thread g takes chunk g, and the head and
    the tail stride over the grid. out sits at idx's offset modulo 16
    bytes, and plane c's store at query q is 16 bytes wide where (c n) %
    4 == 0."""
    vec = _texel_vec()
    head, body, tail = _texel_split(n, idx_offset)
    assert head + body + tail == n and body % vec == 0 and 0 <= tail < vec
    threads = -(-max(body // vec, head, 1) // 256) * 256
    seen = np.zeros((planes, n), np.int64)
    for t in range(threads):
        seen[:, t:head:threads] += 1
        seen[:, head + body + t:n:threads] += 1
    q = head + vec * np.arange(body // vec)             # thread g's chunk
    for c in range(planes):
        if c * n % 4 == 0:
            assert ((idx_offset + 4 * (c * n + q)) % 16 == 0).all()
        for e in range(vec):
            seen[c, q + e] += 1
    return head, seen


@pytest.mark.parametrize("start", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 5, 2048, 921600])
def test_texel_split_covers_each_query_once(n, start):
    """idx viewed from int32 ``start`` of its buffer."""
    off = 4 * start
    head, seen = _texel_cover(n, off)
    assert (seen == 1).all()
    assert head == min(n, (4 - start) % 4)          # the body starts aligned
    assert (off + 4 * head) % 16 == 0 or head == n


@pytest.mark.parametrize("n", [0, 1, 3, 5, 127, 128, 129, 2048, 921600])
def test_texel_packed_walk_covers_each_query_once(n):
    """The packed kernel: a warp for each chunk of 32 * VEC queries, in
    blocks of 8 warps; lane l takes the queries l + 32 k of its warp's
    chunk, where below n; a warp's k-th store covers 32 consecutive
    queries."""
    vec = _texel_vec()
    span = 32 * vec
    warps = -(-(-(-n // span) * 32) // 256) * 8
    seen = np.zeros(n, np.int64)
    for w in range(warps):
        for k in range(vec):
            q = w * span + 32 * k + np.arange(32)            # one store of the warp
            np.add.at(seen, q[q < n], 1)
    assert (seen == 1).all()


def _row_copy_serial(table, idx):
    """The P2 kernel, literally: row idx[i] into slot i % 8, in order."""
    buf = np.zeros((8, table.shape[1]), np.float32)
    for i, r in enumerate(idx):
        buf[i % 8] = table[min(max(r, 0), len(table) - 1)]
    return buf


@pytest.mark.parametrize("n", [5, 8, 256, 1027, 4096])
@pytest.mark.parametrize("row", [128, 4])
def test_row_copy_contract(row, n):
    rng = np.random.default_rng(n + row)
    table = rng.random((2048, row), dtype=np.float32)
    idx = rng.integers(-3, 2051, n, dtype=np.int32)
    got = overlap_probe.row_copy(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), _row_copy_serial(table, idx))


def _row_copy_ring(table, idx, depth, rng):
    """K8a's schedule: issuer k of ``depth`` issues copies k, k + depth,
    ..., copy i once copy i - depth (its own previous) and copy i - 8 (the
    slot's previous) have completed; the issuers take turns and the copies
    in flight complete in a random order, each writing its slot when it
    completes."""
    n = len(idx)
    buf = np.zeros((8, table.shape[1]), np.float32)
    done = np.zeros(n, bool)
    nxt = list(range(depth))                 # each issuer's next copy
    flight = []
    while not done.all():
        ready = [k for k in range(depth) if nxt[k] < n
                 and (nxt[k] < depth or done[nxt[k] - depth])
                 and (nxt[k] < 8 or done[nxt[k] - 8])]
        if ready and (not flight or rng.random() < 0.5):
            k = ready[rng.integers(len(ready))]
            i = nxt[k]
            assert len(flight) < depth
            assert all(j % 8 != i % 8 for j in flight)   # one copy a slot
            flight.append(i)
            nxt[k] += depth
        else:
            assert flight, "no copy can be issued and none is in flight"
            j = flight.pop(rng.integers(len(flight)))
            buf[j % 8] = table[min(max(idx[j], 0), len(table) - 1)]
            done[j] = True
    return buf


@pytest.mark.parametrize("n", [5, 8, 9, 256, 1027, 4096])
@pytest.mark.parametrize("row", [128, 4])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
def test_row_copy_ring_order(depth, row, n):
    """Copies in flight in any order leave the serial copies' buffer:
    a slot is reused 8 copies on, never before its copy has landed."""
    rng = np.random.default_rng(depth * 10_000 + n + row)
    table = rng.random((2048, row), dtype=np.float32)
    idx = rng.integers(-3, 2051, n, dtype=np.int32)
    np.testing.assert_array_equal(_row_copy_ring(table, idx, depth, rng),
                                  _row_copy_serial(table, idx))


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8])
def test_row_copy_contract_every_depth(depth):
    rng = np.random.default_rng(depth)
    table = rng.random((512, 128), dtype=np.float32)
    idx = rng.integers(-3, 515, 1027, dtype=np.int32)
    for mechanism in overlap_probe.MECHANISMS:
        got = overlap_probe.row_copy(torch.from_numpy(table), torch.from_numpy(idx),
                                     mechanism, depth)
        np.testing.assert_array_equal(got.numpy(), _row_copy_serial(table, idx))


@pytest.mark.parametrize("depth", [0, 9, -1])
def test_row_copy_rejects_depth(depth):
    table, idx = torch.zeros((16, 4)), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="depth"):
        overlap_probe.row_copy(table, idx, "tma", depth)


@pytest.mark.parametrize("queries", [(16, 128), (1280 * 720,)])
def test_dsmem_gather_matches_take_along_axis(queries):
    rng = np.random.default_rng(len(queries))
    table = rng.random((256, 512), dtype=np.float32)
    rows = rng.integers(0, 256, queries, dtype=np.int32)
    cols = rng.integers(0, 512, queries, dtype=np.int32)
    got = overlap_probe.dsmem_gather(torch.from_numpy(table), torch.from_numpy(rows),
                                     torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, table[rows, cols])
    if queries == (16, 128):   # the P3 kernel's body, eagerly
        flat = jnp.asarray(table).reshape(1, -1)
        want = jnp.take_along_axis(jnp.broadcast_to(flat, (16, flat.shape[1])),
                                   jnp.asarray(rows * 512 + cols), axis=1)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_dsmem_cluster_partition():
    """K8b keeps rows 64 r .. 64 r + 63 in block rank r of a cluster of 4
    and reads row `row` at rank row // 64, local row row % 64."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.random((256, 512), dtype=np.float32))
    r = torch.from_numpy(rng.integers(-2, 258, 4096, dtype=np.int32))
    c = torch.from_numpy(rng.integers(-2, 514, 4096, dtype=np.int32))
    row = r.clamp(0, 255).long()
    per = overlap_probe.TH // overlap_probe.CLUSTER
    assert per == 64 and per * 512 * 4 == 128 * 1024   # 128 KB a block
    parts = table.reshape(overlap_probe.CLUSTER, per, 512)   # one per rank
    want = parts[row // per, row % per, c.clamp(0, 511).long()]
    assert torch.equal(overlap_probe.dsmem_gather(table, r, c), want)


def _dsmem_cover(n, offsets, threads=64):
    """How often K8b's loops visit each query, on a grid of ``threads``
    threads: the scalar head, the 4-wide body and the scalar tail, each
    strided over the grid as in the kernel."""
    vec = overlap_probe.VEC
    head, body, tail = overlap_probe.dsmem_split(n, offsets)
    assert head + body + tail == n and body % vec == 0 and 0 <= tail < vec
    seen = np.zeros(n, np.int64)
    for t in range(threads):
        seen[t:head:threads] += 1
        for v in range(t, body // vec, threads):
            seen[head + v * vec:head + (v + 1) * vec] += 1
        seen[head + body + t:n:threads] += 1
    return head, seen


@pytest.mark.parametrize("start", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 2048, 921600])
def test_dsmem_split_covers_each_query_once(n, start):
    """rows and cols viewed from int32 ``start`` of their buffers, out
    allocated at the same offset modulo 16 bytes (the wrapper's rule)."""
    off = 4 * start
    head, seen = _dsmem_cover(n, (off, off, off))
    assert (seen == 1).all()
    assert head == min(n, (4 - start) % 4)          # the body starts aligned
    assert (off + 4 * head) % 16 == 0 or head == n
    # offsets that differ: every query on the scalar path, still once
    head, seen = _dsmem_cover(n, (off, off + 4, off))
    assert head == n and (seen == 1).all()


def test_probe_library_builds_apart():
    """The probe sources build into their own library; the render
    library's sources (and so its hash) do not include them."""
    render = {p.name for p in _build.RENDER.src_dir.glob("*.cu")}
    probes = {p.name for p in _build.PROBES.src_dir.glob("*.cu")}
    assert probes == {"trace_dots.cu", "texel_gather.cu", "row_copy.cu",
                      "dsmem_gather.cu"}
    assert not render & probes
    names = {n for n, _ in _build.PROBES.signatures}
    assert names == {"cprt_trace_dots", "cprt_texel_gather", "cprt_row_copy",
                     "cprt_dsmem_gather"}


def test_wrappers_raise_off_the_cpu_and_cuda():
    meta = torch.zeros((8, 4, 16), device="meta")
    with pytest.raises(ValueError):
        trace_probe.trace_dots(meta, torch.zeros((54, 8), device="meta"))
    with pytest.raises(ValueError):
        trace_probe.trace_dots(torch.zeros((8, 4, 16)), torch.zeros((54, 8)), "mxu")
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gather_bench.texel_gather(torch.zeros((1, 8), device="meta"), idx)
    with pytest.raises(ValueError):
        overlap_probe.row_copy(torch.zeros((8, 4), device="meta"), idx)
    with pytest.raises(ValueError):
        overlap_probe.dsmem_gather(torch.zeros((256, 512), device="meta"), idx, idx)


def test_trace_probe_entry_point_cpu(capsys):
    assert trace_probe.main(["--backend", "torch", "--height", "8",
                             "--width", "32", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "ms/frame-equivalent" in out
    assert "max rel err tensor-core vs cuda-core: 0.000e+00" in out
    assert "tensor core wgmma (3xTF32)" in out
    assert "max rel err wgmma vs cuda-core: 0.000e+00" in out


def test_gather_bench_entry_point_cpu(capsys):
    assert gather_bench.main(["--backend", "torch", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("correct: True") == 6 and "False" not in out


def test_overlap_probe_entry_points_cpu(capsys):
    dev = torch.device("cpu")
    p1 = overlap_probe.p1_stream_overlap(dev, 32, 16, iters=1)
    assert set(p1["ms"]) == {"trivial", "kernel", "gather", "together"}
    assert p1["queries"] == 32 * 16
    p2 = overlap_probe.p2_row_copy_cost(dev, iters=1)
    assert len(p2["correct"]) == 48 and all(p2["correct"].values())
    p3 = overlap_probe.p3_dsmem_gather(dev, iters=1)
    assert set(p3["correct"]) == {"16x128", "921600"}
    assert all(p3["correct"].values())
    out = capsys.readouterr().out
    assert "P1 together < kernel + gather" in out and "ns/copy" in out
