"""Checkpoint / resume of a progressive render.

The JAX package's format (``cpuperformanceraytracer_tpu.io.checkpoint``),
so either package resumes the other's checkpoints: one ``.npz`` with
``version`` 1, ``frame``, the accumulator planes ``r``, ``g``, ``b``
((H, W) f32) and ``config``, the JSON of the config's fields. The port's
fields are a subset of the JAX config's (``accumulate`` included, which
the JAX fingerprint reads), so the JAX loader builds its config from the
port's JSON; the port reads a JAX config through
``RenderConfig.from_dict``, which drops the TPU knobs.

A checkpoint resumes only under a config with the same image
fingerprint (every field that shapes the accumulated image); any other
starts fresh rather than averaging two different renders. The file is
written to a temporary name and moved into place, so a preempted save
leaves the previous checkpoint whole.

The archive is the one ``np.savez_compressed`` writes: the same members,
headers and zip64 extras, each member DEFLATED. ``zipfile`` takes no data
already deflated, so the zip's records are written here. Its members are
deflated by one of two routes, which the accumulator's device chooses:

- A CPU accumulator: each member is deflated at zlib's level 6 in
  ``CHUNK``-byte pieces on a pool of host threads, one a CPU the process
  may use, made at the first save with more than one chunk. Each piece
  is a raw deflate primed with the 32 KiB before it; it ends in a sync
  flush, the member's last piece in the stream's end, so the pieces laid
  end to end are one deflate stream, compressed about as well as one
  stream on one core.
- A CUDA accumulator: the card deflates the three planes where they lie
  (``kernels/deflate.py``, ``csrc/deflate.cu``, 32 KiB slices a block)
  and only their compressed bytes and CRC-32s come to the host, through
  a pinned buffer; each plane's ``.npy`` header goes ahead of its body's
  stream, deflated by zlib and sync-flushed, and the small members take
  the host route. The kernel does not deflate at zlib's level 6: it
  parses otherwise (chains of 16 candidates, a block a slice, matches cut
  at each thread's 128 bytes), so its bytes differ from zlib's, 0.15%
  more of them on a 4K render, while the members inflate to
  the same bytes, which is all a reader sees. zlib's own parse is serial
  and has no counterpart on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
from numpy.lib import format as npy

from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.kernels import deflate
from cpuperformanceraytracer_tpu_torch.utils import profiling

FORMAT_VERSION = 1

# Bytes of a member deflated as one task. A 4K plane is 32 of them, a
# save 96: 12 a worker on 8 CPUs, so the last to finish waits at most one
# chunk's time. Each is 32 times the window that primes it, and its
# fresh deflate state and sync flush cost about 0.01% of its output.
CHUNK = 1 << 20
WINDOW = 1 << 15        # deflate's: how far back a chunk's matches reach
LEVEL = 6               # zlib's default, np.savez_compressed's

# the zip's records, as ``zipfile`` writes them (APPNOTE 4.3)
_LOCAL = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_END = struct.Struct("<4s4H2LH")
_END64 = struct.Struct("<4sQ2H2L4Q")
_LOCATOR64 = struct.Struct("<4sLQL")
_ZIP64_LIMIT = (1 << 31) - 1    # ``zipfile``'s: a size or offset past it
_ZIP64_VERSION = 45
_DEFLATED = 8
_DOS_DATE = (0, 1 << 5 | 1)     # 1980-01-01 00:00, ``zipfile.ZipInfo``'s
_UNIX = 3
_MODE = 0o600 << 16             # ?rw-------, ``zipfile``'s for a new member

_pool = None    # (pid, executor): a forked child makes its own

# the JAX package's _IMAGE_FIELDS
IMAGE_FIELDS = (
    "width", "height", "spp", "bounces", "scene", "env_mode",
    "env_sampling", "ambient", "env_flip_xz", "unit_vector_sampler",
    "jitter", "rng", "roulette", "accumulate",
)


def image_fingerprint(cfg) -> tuple:
    """The image-content identity of a config (either package's): equal
    fingerprints accumulate identical progressive frames."""
    return tuple(
        (f, tuple(v) if isinstance(v, (list, tuple)) else v)
        for f, v in ((f, getattr(cfg, f)) for f in IMAGE_FIELDS))


class _Member:
    """One ``.npy`` member of the archive: its name, the ``.npy`` header
    ``np.savez`` writes for the value, and the value's C-order bytes."""

    def __init__(self, name: str, value):
        a = np.asanyarray(value)    # C-contiguous, as the caller made it
        head = io.BytesIO()
        npy.write_array_header_1_0(head, npy.header_data_from_array_1_0(a))
        self.name = f"{name}.npy".encode()
        self.head = head.getvalue()
        self.body = memoryview(a.reshape(-1).view(np.uint8))
        self.size = len(self.head) + self.body.nbytes
        self.chunks = [(i, min(i + CHUNK, self.size))
                       for i in range(0, self.size, CHUNK)]

    def part(self, a: int, b: int):
        """Bytes ``[a, b)`` of the member (header, then body)."""
        n = len(self.head)
        if a >= n:
            return self.body[a - n:b - n]
        return self.head[a:b] + self.body[:max(b - n, 0)].tobytes()

    def crc(self) -> int:
        return zlib.crc32(self.body, zlib.crc32(self.head))

    def deflate(self, a: int, b: int) -> bytes:
        """Bytes ``[a, b)`` as raw deflate, primed with the window before
        ``a``; a sync flush ends all but the member's last chunk, which
        ends the stream."""
        z = zlib.compressobj(LEVEL, zlib.DEFLATED, -15,
                             zdict=self.part(max(a - WINDOW, 0), a))
        last = b == self.size
        return z.compress(self.part(a, b)) + z.flush(
            zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


class _Plane:
    """A plane member that ``kernels/deflate`` deflates where it lies: its
    name, the ``.npy`` header ``np.savez`` writes for a C-order (H, W)
    array of its dtype, and its size."""

    def __init__(self, name: str, plane: torch.Tensor):
        head = io.BytesIO()
        npy.write_array_header_1_0(head, {
            "descr": npy.dtype_to_descr(
                torch.empty(0, dtype=plane.dtype).numpy().dtype),
            "fortran_order": False, "shape": tuple(plane.shape)})
        self.name = f"{name}.npy".encode()
        self.head = head.getvalue()
        self.body_size = plane.numel() * plane.element_size()
        self.size = len(self.head) + self.body_size

    def deflated_head(self) -> bytes:
        """The header as raw deflate ending in a sync flush, for the body's
        stream to follow."""
        z = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
        return z.compress(self.head) + z.flush(zlib.Z_SYNC_FLUSH)


def _kernel_entries(accum: torch.Tensor, frame: int, cfg) -> list:
    """The save's entries (member, CRC-32, deflated pieces), the planes
    deflated by ``kernels/deflate`` (the kernel for a CUDA accumulator,
    which stays there; the plain version for a CPU one, which only tests
    take) and the small members on this thread."""
    planes = accum.detach().contiguous()
    shaped = [_Plane(k, p) for k, p in zip("rgb", planes)]
    small = [_Member(k, v) for k, v in (
        ("version", FORMAT_VERSION), ("frame", int(frame)),
        ("config", json.dumps(dataclasses.asdict(cfg))))]
    with profiling.span("checkpoint.deflate"):
        done = deflate.deflate(planes.view(-1).view(torch.uint8),
                               [m.body_size for m in shaped],
                               [zlib.crc32(m.head) for m in shaped])
        heads = [m.deflated_head() for m in shaped]
        version, frame_, config = _deflate(small)
    with profiling.span("checkpoint.copy"):
        bodies = done.fetch()
    return [version, frame_] + [
        (m, crc, [head, body])
        for m, head, (body, crc) in zip(shaped, heads, bodies)] + [config]


def _executor() -> ThreadPoolExecutor:
    """The process's pool, a worker a CPU it may use (zlib lets go of the
    GIL while it deflates or sums)."""
    global _pool
    if _pool is None or _pool[0] != os.getpid():
        _pool = (os.getpid(), ThreadPoolExecutor(
            len(os.sched_getaffinity(0)), thread_name_prefix="checkpoint"))
    return _pool[1]


def _deflate(members) -> list:
    """[(member, CRC-32, [its deflated chunks])]: every member's chunks
    and CRC as tasks, on the pool where a member has more than one chunk,
    else on this thread. A task's exception reaches the caller."""
    tasks = [m.crc for m in members] + [
        functools.partial(m.deflate, a, b)
        for m in members for a, b in m.chunks]
    chunks = len(tasks) - len(members)
    if chunks > len(members):
        done = list(_executor().map(lambda task: task(), tasks))
    else:
        done = [task() for task in tasks]
    out, i = [], len(members)
    for m, crc in zip(members, done):
        n = len(m.chunks)
        out.append((m, crc, done[i:i + n]))
        i += n
    return out


def _write_zip(f, entries) -> None:
    """The zip of ``entries`` ((member, CRC, deflated chunks)) into ``f``,
    record for record as ``np.savez_compressed`` has ``zipfile`` write
    it: each local header with its zip64 extra, the central directory
    (zip64 extras where a size or offset needs them, and the zip64 end
    records where the directory's offset or size does)."""
    central = []
    for m, crc, chunks in entries:
        offset, deflated = f.tell(), sum(map(len, chunks))
        f.write(_LOCAL.pack(b"PK\x03\x04", _ZIP64_VERSION, 0, 0, _DEFLATED,
                            *_DOS_DATE, crc, 0xFFFFFFFF, 0xFFFFFFFF,
                            len(m.name), 20)
                + m.name + struct.pack("<HHQQ", 1, 16, m.size, deflated))
        f.writelines(chunks)
        sizes = [m.size, deflated]
        extra = (sizes if max(sizes) > _ZIP64_LIMIT else []) + (
            [offset] if offset > _ZIP64_LIMIT else [])
        packed = (struct.pack(f"<HH{len(extra)}Q", 1, 8 * len(extra), *extra)
                  if extra else b"")
        usize, csize = ((0xFFFFFFFF, 0xFFFFFFFF) if max(sizes) > _ZIP64_LIMIT
                        else (m.size, deflated))
        central.append(_CENTRAL.pack(
            b"PK\x01\x02", _ZIP64_VERSION, _UNIX, _ZIP64_VERSION, 0, 0,
            _DEFLATED, *_DOS_DATE, crc, csize, usize, len(m.name),
            len(packed), 0, 0, 0, _MODE,
            0xFFFFFFFF if offset > _ZIP64_LIMIT else offset)
            + m.name + packed)
    start = f.tell()
    f.write(b"".join(central))
    end = f.tell()
    count, size = len(central), end - start
    if start > _ZIP64_LIMIT or size > _ZIP64_LIMIT:
        f.write(_END64.pack(b"PK\x06\x06", 44, _ZIP64_VERSION,
                            _ZIP64_VERSION, 0, 0, count, count, size, start))
        f.write(_LOCATOR64.pack(b"PK\x06\x07", 0, end, 1))
    f.write(_END.pack(b"PK\x05\x06", 0, 0, count, count, size,
                      min(start, 0xFFFFFFFF), 0))


def save_checkpoint(path: str, accum: torch.Tensor, frame: int,
                    cfg: RenderConfig) -> None:
    """Write the (3, H, W) accumulator, the frame index and the config,
    deflated on the card where the accumulator is a CUDA tensor (the
    module's note). Should the save fail, its temporary file goes and
    ``path`` keeps the checkpoint it had."""
    with profiling.span("checkpoint.save"):
        if accum.device.type == "cuda":
            entries = _kernel_entries(accum, frame, cfg)
        else:
            with profiling.span("checkpoint.copy"):
                planes = accum.detach().cpu().contiguous().numpy()
            members = [_Member(k, v) for k, v in (
                ("version", FORMAT_VERSION), ("frame", int(frame)),
                ("r", planes[0]), ("g", planes[1]), ("b", planes[2]),
                ("config", json.dumps(dataclasses.asdict(cfg))))]
            with profiling.span("checkpoint.deflate"):
                entries = _deflate(members)
        tmp = f"{path}.{os.getpid()}.tmp"
        with profiling.span("checkpoint.write"):
            try:
                with open(tmp, "wb") as f:
                    _write_zip(f, entries)
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise


def load_checkpoint(path: str) -> Tuple[np.ndarray, int, RenderConfig]:
    """(accumulator (3, H, W) f32, frame, config) of a checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        cfg = RenderConfig.from_dict(json.loads(str(z["config"])))
        accum = np.stack([z["r"], z["g"], z["b"]]).astype(np.float32)
        return accum, int(z["frame"]), cfg


def resume_or_fresh(path: Optional[str], cfg: RenderConfig,
                    device="cpu") -> Tuple[torch.Tensor, int]:
    """(accumulator on ``device``, start frame): the checkpoint's when it
    exists and its fingerprint equals ``cfg``'s, else zeros and 0."""
    if path and os.path.exists(path):
        accum, frame, saved = load_checkpoint(path)
        if image_fingerprint(saved) == image_fingerprint(cfg):
            return torch.as_tensor(accum, device=device).contiguous(), frame
    return torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32,
                       device=device), 0
