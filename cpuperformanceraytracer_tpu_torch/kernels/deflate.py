"""Deflate (RFC 1951) of a tensor's bytes on the card, and its plain
version.

Replaces no TPU kernel: the JAX package saves a checkpoint with
``np.savez_compressed``, which deflates on the host. It was added for the
port's checkpoint (``io/checkpoint.py``): a 4K accumulator is 99.5 MB,
which eight host threads deflate at about 100 MB/s while the card sits
idle. ``csrc/deflate.cu`` deflates it where it lies, and only the
compressed bytes and the CRC-32s cross to the host.

The input is a 1-D uint8 tensor of members laid end to end (``sizes``).
Each member becomes one raw deflate stream, made of ``SLICE``-byte
slices that are deflated independently, one CUDA block each:

- A slice's matches reach back up to ``WINDOW`` bytes, into the bytes
  before it in its member, as zlib's do. Positions are chained by a
  hash of their next three bytes (each position's nearest earlier one
  with the same hash, within the window).
- The slice is parsed in ``SUB``-byte pieces, one a thread, with zlib's
  one-step lazy evaluation: the longest of the first ``CHAIN``
  candidates, the nearest on ties; a match stops at its piece's end; a
  3-byte match further than ``TOO_FAR`` is not taken.
- Each slice is one dynamic Huffman block (code lengths limited to 15,
  and 7 for the code-length code, by Moffat's in-place algorithm on the
  symbols sorted by count and then by symbol, and miniz's Kraft
  repair), or a stored block where that is smaller. All but a member's
  last slice end in a sync flush (an empty stored block), the last in
  the final block, so the slices laid end to end are one stream.
- A member's CRC-32, started from ``crc_starts`` (the CRC of whatever
  precedes the member in its file), is combined from the slices' on the
  card.

The output is a function of the input bytes alone. zlib's level 6 parses
otherwise (hash chains of 128, blocks of 16384 symbols), so the bytes
differ from zlib's, while the streams inflate to the same members; a
rendered 4K accumulator takes 0.15% more bytes than
``np.savez_compressed``'s.

``deflate_reference`` is the plain version: the kernel's algorithm in
numpy, slice for slice, and its bytes equal the kernel's; it is slow and
meant for tests on small inputs. ``deflate`` is the wrapper: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel
(counted through ``profiling.count_launch``); any other device raises.
"""

from __future__ import annotations

import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.kernels._build import check, load_library
from cpuperformanceraytracer_tpu_torch.utils.profiling import count_launch

SLICE = 1 << 15         # bytes of a member one block deflates
WINDOW = 1 << 15        # how far back a match may reach (deflate's limit)
THREADS = 256           # a block's threads: each parses SUB bytes
SUB = SLICE // THREADS
HASH_BITS = 13
CHAIN = 16              # candidates tried at a position
LAZY = 32               # a match this long is taken without a lazy look
TOO_FAR = 4096          # a 3-byte match further back is not taken
# bytes a slice's output may take: its stored form, or less
SLOT = SLICE + 256
# the empty final block of a member with no bytes (a fixed block's EOB)
EMPTY = b"\x03\x00"

# deflate's length and distance codes (RFC 1951 3.2.5)
_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
             43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
              257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
              12289, 16385, 24577]
_DIST_EXTRA = [0, 0, 0, 0] + [i // 2 for i in range(2, 28)]
# the order of the code-length code's lengths in the header
_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15]


def _len_code(n: int) -> int:
    """The length symbol's index (0-28, symbol 257 + it) of length n."""
    return max(i for i, b in enumerate(_LEN_BASE) if b <= n)


def _dist_code(d: int) -> int:
    return max(i for i, b in enumerate(_DIST_BASE) if b <= d)


_LEN_CODE = np.array([0, 0, 0] + [_len_code(n) for n in range(3, 259)])
_DIST_CODE = np.array([0] + [_dist_code(d) for d in range(1, 32769)])


# ---- LZ77 ------------------------------------------------------------------

def _hashes(region: np.ndarray) -> np.ndarray:
    """The hash of each position's next three bytes (none for the last
    two positions)."""
    b = region.astype(np.uint32)
    word = b[:-2] | (b[1:-1] << 8) | (b[2:] << 16)
    return ((word * np.uint32(0x9E3779B1)) >> np.uint32(32 - HASH_BITS))


def _chains(region: np.ndarray) -> np.ndarray:
    """prev[r]: the distance back from position r to the nearest earlier
    position with the same hash, 0 where there is none within WINDOW (and
    at the last two positions)."""
    h = _hashes(region) if len(region) >= 3 else np.zeros(0, np.uint32)
    pos = np.arange(len(h))
    order = np.lexsort((pos, h))
    prev = np.zeros(len(region), np.int64)
    same = h[order[1:]] == h[order[:-1]]
    d = order[1:] - order[:-1]
    take = same & (d <= WINDOW)
    prev[order[1:][take]] = d[take]
    return prev


def _matches(region: np.ndarray, prev: np.ndarray, start: int,
             limits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(length, distance) of the match taken at each position start + i
    (lengths 0 where none): the longest of the first CHAIN candidates down
    the position's chain within WINDOW, at most ``limits[i]`` bytes, the
    nearest on ties; under 3 bytes, or 3 bytes from further than
    TOO_FAR, is no match."""
    n = len(limits)
    p = start + np.arange(n)
    best_len = np.zeros(n, np.int64)
    best_dist = np.zeros(n, np.int64)
    dist = np.zeros(n, np.int64)
    q = p.copy()
    live = limits >= 3
    for _ in range(CHAIN):
        d = np.where(live, prev[q], 0)
        live &= d > 0
        dist += d
        live &= dist <= WINDOW
        q = np.where(live, q - d, q)
        if not live.any():
            break
        # the length of the match at q: bytes equal in a row
        length = np.zeros(n, np.int64)
        run = live.copy()
        for i in range(int(limits[live].max())):
            run &= i < limits
            idx = np.nonzero(run)[0]
            if not len(idx):
                break
            eq = region[q[idx] + i] == region[p[idx] + i]
            run[idx] = eq
            length[idx[eq]] += 1
        better = live & (length > best_len)
        best_len = np.where(better, length, best_len)
        best_dist = np.where(better, dist, best_dist)
    bad = (best_len < 3) | ((best_len == 3) & (best_dist > TOO_FAR))
    best_len[bad] = 0
    best_dist[bad] = 0
    return best_len, best_dist


def _parse(lengths: np.ndarray, dists: np.ndarray, n: int) -> list:
    """The slice's tokens, piece by piece: a literal is its position in
    the slice (an int), a match (length, distance)."""
    tokens = []
    for a in range(0, n, SUB):
        b = min(a + SUB, n)
        p = a
        while p < b:
            length, dist = int(lengths[p]), int(dists[p])
            if length == 0:
                tokens.append(p)
                p += 1
                continue
            if length < LAZY and p + 1 < b and lengths[p + 1] > length:
                tokens.append(p)        # the match at p + 1 is longer
                p += 1
                continue
            tokens.append((length, dist))
            p += length
    return tokens


# ---- Huffman ---------------------------------------------------------------

def _code_lengths(freq: Sequence[int], max_len: int) -> List[int]:
    """Code lengths of a prefix code for ``freq``, none over ``max_len``
    bits: Moffat and Katajainen's in-place Huffman over the used symbols
    sorted by count, then by symbol; then miniz's repair of the Kraft sum
    after the longest codes are cut to ``max_len``; the most frequent
    symbols take the shortest codes. At least two symbols are used: where
    fewer are, the lowest unused ones count 1."""
    freq = list(freq)
    used = [s for s, f in enumerate(freq) if f]
    for s in range(len(freq)):
        if len(used) >= 2:
            break
        if not freq[s]:
            freq[s] = 1
            used = [s for s, f in enumerate(freq) if f]
    syms = sorted(used, key=lambda s: (freq[s], s))
    a = [freq[s] for s in syms]
    n = len(a)
    # Moffat-Katajainen: a[i] becomes the depth of the i-th symbol
    a[0] += a[1]
    root, leaf = 0, 2
    for nxt in range(1, n - 1):
        if leaf >= n or a[root] < a[leaf]:
            a[nxt] = a[root]
            a[root] = nxt
            root += 1
        else:
            a[nxt] = a[leaf]
            leaf += 1
        if leaf >= n or (root < nxt and a[root] < a[leaf]):
            a[nxt] += a[root]
            a[root] = nxt
            root += 1
        else:
            a[nxt] += a[leaf]
            leaf += 1
    a[n - 2] = 0
    for nxt in range(n - 3, -1, -1):
        a[nxt] = a[a[nxt]] + 1
    avbl, used_n, depth, root, nxt = 1, 0, 0, n - 2, n - 1
    while avbl > 0:
        while root >= 0 and a[root] == depth:
            used_n += 1
            root -= 1
        while avbl > used_n:
            a[nxt] = depth
            nxt -= 1
            avbl -= 1
        avbl, depth, used_n = 2 * used_n, depth + 1, 0
    # cut to max_len, then mend the Kraft sum
    count = [0] * 33
    for d in a:
        count[min(d, max_len)] += 1
    total = sum(count[i] << (max_len - i) for i in range(1, max_len + 1))
    while total != 1 << max_len:
        count[max_len] -= 1
        for i in range(max_len - 1, 0, -1):
            if count[i]:
                count[i] -= 1
                count[i + 1] += 2
                break
        total -= 1
    lengths = [0] * len(freq)
    j = n
    for i in range(1, max_len + 1):
        for _ in range(count[i]):
            j -= 1
            lengths[syms[j]] = i
    return lengths


def _codes(lengths: Sequence[int]) -> List[int]:
    """Canonical codes, bit-reversed for deflate's LSB-first packing."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    count[0] = 0
    nxt, code = [0] * 16, 0
    for i in range(1, 16):
        code = (code + count[i - 1]) << 1
        nxt[i] = code
    out = [0] * len(lengths)
    for s, n in enumerate(lengths):
        if n:
            c = nxt[n]
            nxt[n] += 1
            out[s] = int(f"{c:0{n}b}"[::-1], 2)
    return out


def _run_lengths(seq: Sequence[int]) -> list:
    """The code-length symbols of ``seq`` (literal-length lengths, then
    distance lengths): (symbol, extra bits' value)."""
    out, i, n = [], 0, len(seq)
    while i < n:
        v, run = seq[i], 1
        while i + run < n and seq[i + run] == v:
            run += 1
        i += run
        if v == 0:
            while run >= 11:
                k = min(run, 138)
                out.append((18, k - 11))
                run -= k
            if run >= 3:
                out.append((17, run - 3))
                run = 0
            out += [(0, 0)] * run
        else:
            out.append((v, 0))
            run -= 1
            while run >= 3:
                k = min(run, 6)
                out.append((16, k - 3))
                run -= k
            out += [(v, 0)] * run
    return out


class _Bits:
    """Fields (value, bits) laid LSB first, as deflate packs them."""

    def __init__(self):
        self.values, self.widths = [], []

    def put(self, value: int, width: int) -> None:
        if width:
            self.values.append(value)
            self.widths.append(width)

    @property
    def size(self) -> int:
        return sum(self.widths)

    def bytes(self) -> bytes:
        values = np.array(self.values, np.int64)
        widths = np.array(self.widths, np.int64)
        at = np.concatenate([[0], np.cumsum(widths)[:-1]])
        total = int(widths.sum())
        bits = np.zeros(-(-total // 8) * 8, np.uint8)
        for j in range(int(widths.max(initial=0))):
            on = widths > j
            bits[at[on] + j] = (values[on] >> j) & 1
        return np.packbits(bits, bitorder="little").tobytes()


def _block(data: np.ndarray, tokens: list, final: bool) -> bytes:
    """The slice's deflate bytes: one dynamic block of ``tokens`` or, where
    not smaller, a stored block of ``data``; a sync flush after a block
    that is not the last."""
    ll = [0] * 286
    dd = [0] * 30
    for t in tokens:
        if isinstance(t, tuple):
            ll[257 + _LEN_CODE[t[0]]] += 1
            dd[_DIST_CODE[t[1]]] += 1
        else:
            ll[data[t]] += 1
    ll[256] = 1
    ll_len = _code_lengths(ll, 15)
    d_len = _code_lengths(dd, 15)
    hlit = max(s for s, n in enumerate(ll_len) if n) + 1
    hdist = max(s for s, n in enumerate(d_len) if n) + 1
    rle = _run_lengths(ll_len[:hlit] + d_len[:hdist])
    cl = [0] * 19
    for s, _ in rle:
        cl[s] += 1
    cl_len = _code_lengths(cl, 7)
    hclen = max(i for i, s in enumerate(_CL_ORDER) if cl_len[s]) + 1
    hclen = max(hclen, 4)
    ll_code, d_code, cl_code = _codes(ll_len), _codes(d_len), _codes(cl_len)

    bits = _Bits()
    bits.put(int(final) | 2 << 1, 3)
    bits.put(hlit - 257, 5)
    bits.put(hdist - 1, 5)
    bits.put(hclen - 4, 4)
    for s in _CL_ORDER[:hclen]:
        bits.put(cl_len[s], 3)
    for s, extra in rle:
        bits.put(cl_code[s], cl_len[s])
        bits.put(extra, {16: 2, 17: 3, 18: 7}.get(s, 0))
    for t in tokens:
        if isinstance(t, tuple):
            length, dist = t
            lc, dc = _LEN_CODE[length], _DIST_CODE[dist]
            bits.put(ll_code[257 + lc], ll_len[257 + lc])
            bits.put(length - _LEN_BASE[lc], _LEN_EXTRA[lc])
            bits.put(d_code[dc], d_len[dc])
            bits.put(dist - _DIST_BASE[dc], _DIST_EXTRA[dc])
        else:
            bits.put(ll_code[data[t]], ll_len[data[t]])
    bits.put(ll_code[256], ll_len[256])
    size = bits.size
    if not final:
        size += 3
    dynamic = -(-size // 8) + (0 if final else 4)
    stored = 5 + len(data)
    if dynamic >= stored:
        n = len(data)
        return (bytes([int(final)]) + n.to_bytes(2, "little")
                + (n ^ 0xFFFF).to_bytes(2, "little") + data.tobytes())
    if not final:
        bits.put(0, 3)
    return bits.bytes() + (b"" if final else b"\x00\x00\xff\xff")


def deflate_slice(member: np.ndarray, start: int) -> bytes:
    """The deflate bytes of the slice of ``member`` (uint8) at ``start``,
    as the kernel's block makes them."""
    end = min(start + SLICE, len(member))
    base = max(start - WINDOW, 0)
    region = member[base:end]
    prev = _chains(region)
    n = end - start
    at = np.arange(n)
    limits = np.minimum((at // SUB + 1) * SUB, n) - at
    lengths, dists = _matches(region, prev, start - base, limits)
    tokens = _parse(lengths, dists, n)
    return _block(region[start - base:], tokens, end == len(member))


def deflate_reference(data, sizes: Sequence[int],
                      crc_starts: Sequence[int] = None
                      ) -> List[Tuple[bytes, int]]:
    """The plain version: [(raw deflate stream, CRC-32)] of each member of
    ``data`` (bytes or a uint8 array, the members end to end), each CRC
    started from its ``crc_starts`` entry (0 by default)."""
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    crc_starts = crc_starts or [0] * len(sizes)
    out, at = [], 0
    for size, crc in zip(sizes, crc_starts):
        member = data[at:at + size]
        at += size
        stream = b"".join(deflate_slice(member, s)
                          for s in range(0, size, SLICE)) or EMPTY
        out.append((stream, zlib.crc32(member, crc)))
    return out


# ---- the kernel ------------------------------------------------------------

def plan(sizes: Sequence[int], crc_starts: Sequence[int]):
    """The kernel's tables: jobs (slices, 4) int64, a slice's {offset of
    its first byte, bytes of its member before it that it may reach, its
    bytes, 1 if its member's last}; members (members, 3) int64, a
    member's {first slice, slices, CRC-32 to start from}."""
    jobs, members, at = [], [], 0
    for size, crc in zip(sizes, crc_starts):
        members.append((len(jobs), -(-size // SLICE), crc))
        for s in range(0, size, SLICE):
            n = min(SLICE, size - s)
            jobs.append((at + s, min(s, WINDOW), n, int(s + n == size)))
        at += size
    return (np.array(jobs, np.int64).reshape(-1, 4),
            np.array(members, np.int64).reshape(-1, 3))


class Deflated:
    """What ``deflate`` made: ``fetch()`` gives [(stream, CRC-32)] a
    member. On the card the streams stay there, packed end to end, until
    ``fetch()`` copies them into a pinned host buffer of the call's own,
    which its views keep alive (torch's caching host allocator hands a
    freed buffer to the next call, so a save pins no new pages)."""

    def __init__(self, streams=None, packed=None, sizes=None, crcs=None):
        self._streams, self._packed = streams, packed
        self._sizes, self._crcs = sizes, crcs

    def fetch(self) -> List[Tuple[object, int]]:
        if self._streams is not None:
            return self._streams
        total = sum(self._sizes)
        host = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
        host[:total].copy_(self._packed[:total])
        view, out, at = host.numpy(), [], 0
        for size, crc in zip(self._sizes, self._crcs):
            out.append((view[at:at + size] if size else EMPTY, crc))
            at += size
        return out


def deflate(data: torch.Tensor, sizes: Sequence[int],
            crc_starts: Sequence[int] = None) -> Deflated:
    """Deflate each member of ``data`` (a 1-D uint8 tensor, the members of
    ``sizes`` end to end) into its own raw deflate stream, its CRC-32
    started from its ``crc_starts`` entry. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, and the call returns once
    the card has finished (the members' sizes read back)."""
    crc_starts = list(crc_starts or [0] * len(sizes))
    if (data.dim() != 1 or data.dtype != torch.uint8
            or not data.is_contiguous() or sum(sizes) != data.numel()
            or len(crc_starts) != len(sizes) or min(sizes, default=0) < 0):
        raise ValueError(f"deflate: data {tuple(data.shape)} {data.dtype} "
                         f"for sizes {list(sizes)}")
    if data.device.type == "cpu":
        return Deflated(deflate_reference(data.numpy(), sizes, crc_starts))
    if data.device.type != "cuda":
        raise ValueError(f"deflate: unsupported device {data.device}")
    jobs, members = plan(sizes, crc_starts)
    dev = data.device
    n = len(jobs)
    scratch = lambda count, dtype: torch.empty(max(count, 1), dtype=dtype,
                                               device=dev)
    with torch.cuda.device(dev):
        jobs_d = torch.from_numpy(jobs).to(dev)
        members_d = torch.from_numpy(members).to(dev)
        tokens = scratch(n * SLICE, torch.int32)
        slots = scratch(n * SLOT, torch.uint8)
        out_len = scratch(n, torch.int32)
        crcs = scratch(n, torch.int32)
        packed = scratch(n * SLOT, torch.uint8)
        member_out = scratch(2 * len(sizes), torch.int64)
        err = load_library().cprt_deflate(
            data.data_ptr(), jobs_d.data_ptr(), n, members_d.data_ptr(),
            len(sizes), tokens.data_ptr(), slots.data_ptr(),
            out_len.data_ptr(), crcs.data_ptr(), packed.data_ptr(),
            member_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check(err, "deflate")
        count_launch(deflate)
        got = member_out[:2 * len(sizes)].view(-1, 2).tolist()
    return Deflated(packed=packed, sizes=[b for b, _ in got],
                    crcs=[c for _, c in got])


deflate.launches = 0
