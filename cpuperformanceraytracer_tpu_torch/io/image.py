"""Own BMP and PNG writers (no external image deps).

Replaces the reference's stb_image_write usage (WriteImage,
asset_loading.cpp:48-54 — BMP via stbi_write_bmp). A copy of
``cpuperformanceraytracer_tpu.io.image``: ``write_bmp`` takes the native
encoder of ``io/native.py`` when ``native/librgbe.so`` is built, as the
JAX writer does, and the numpy encoder (``write_bmp_numpy``) otherwise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_bmp(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) u8 RGB as an uncompressed 24-bit BMP.

    Matches the output format of the reference's offline renderer
    (output_image.bmp): bottom-up rows, BGR channel order, rows padded
    to 4 bytes.
    """
    from cpuperformanceraytracer_tpu_torch.io.native import write_bmp_native

    if not write_bmp_native(path, rgb):
        write_bmp_numpy(path, rgb)


def write_bmp_numpy(path: str, rgb: np.ndarray) -> None:
    """``write_bmp``'s numpy encoder."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    bgr = rgb[::-1, :, ::-1]  # bottom-up, BGR
    row_size = (w * 3 + 3) & ~3
    pad = row_size - w * 3
    if pad:
        bgr = np.pad(bgr, ((0, 0), (0, 0), (0, 0)))
        rows = np.zeros((h, row_size), np.uint8)
        rows[:, : w * 3] = bgr.reshape(h, w * 3)
    else:
        rows = bgr.reshape(h, row_size)
    pixel_bytes = rows.tobytes()

    file_size = 14 + 40 + len(pixel_bytes)
    header = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pixel_bytes),
                       2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(info)
        f.write(pixel_bytes)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) u8 RGB as a PNG (zlib, filter 0)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_bmp(path: str) -> np.ndarray:
    """Minimal 24-bit BMP reader (round-trip testing)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    offset = struct.unpack_from("<I", data, 10)[0]
    w, h = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError(f"unsupported bpp {bpp}")
    row_size = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=abs(h) * row_size, offset=offset)
    rows = rows.reshape(abs(h), row_size)[:, : w * 3].reshape(abs(h), w, 3)
    if h > 0:
        rows = rows[::-1]
    return rows[:, :, ::-1].copy()  # BGR -> RGB
