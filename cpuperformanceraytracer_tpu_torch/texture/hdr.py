"""Radiance RGBE (.hdr) reader/writer.

Own implementation of the subset of stb_image/stb_image_write the
reference uses for HDR environment maps (asset_loading.cpp:9-16,56-59):
new-style RLE and flat scanlines, mantissa*2^(e-136) decode (stb's
rule), optional vertical flip (the reference always flips on load,
asset_loading.cpp:12).

A copy of ``cpuperformanceraytracer_tpu.texture.hdr`` (the JAX
package's ``texture`` package imports jax, so the port cannot import it
from there): ``read_hdr`` takes the native decoder of ``io/native.py``
when ``native/librgbe.so`` is built, as the JAX reader does, and the
pure-numpy decoder (``read_hdr_numpy``) otherwise.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(H, W, 4) u8 RGBE -> (H, W, 3) f32, stb semantics:
    f = 2^(e-136), rgb = mantissa * f, zero when e == 0."""
    mant = rgbe[..., :3].astype(np.float32)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    out = mant * scale[..., None]
    out[e == 0] = 0.0
    return out


def _encode_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) f32 -> (H, W, 4) u8 RGBE (stb_image_write rule)."""
    rgb = np.maximum(rgb.astype(np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    rgbe = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    m, e = np.frexp(maxc[nz])
    scale = m * 256.0 / maxc[nz]
    rgbe[nz, :3] = np.clip(rgb[nz] * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[nz, 3] = (e + 128).astype(np.uint8)
    return rgbe


def _read_scanline_rle(data: memoryview, pos: int, width: int) -> Tuple[np.ndarray, int]:
    """One new-style RLE scanline -> (width, 4) u8, advancing pos."""
    out = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            count = data[pos]
            pos += 1
            if count > 128:  # run
                out[c, x : x + count - 128] = data[pos]
                pos += 1
                x += count - 128
            else:  # literal
                out[c, x : x + count] = np.frombuffer(data[pos : pos + count], np.uint8)
                pos += count
                x += count
        if x != width:
            raise ValueError("corrupt RLE scanline")
    return out.T, pos


def read_hdr(path: str, flip_vertical: bool = True) -> np.ndarray:
    """Read a Radiance .hdr file into (H, W, 3) f32 linear RGB.

    flip_vertical=True matches the reference's
    stbi_set_flip_vertically_on_load(true) (asset_loading.cpp:12): row 0
    of the returned array is the BOTTOM scanline of the file.
    """
    from cpuperformanceraytracer_tpu_torch.io.native import read_hdr_native

    native = read_hdr_native(path, flip_vertical)
    if native is not None:
        return native
    return read_hdr_numpy(path, flip_vertical)


def read_hdr_numpy(path: str, flip_vertical: bool = True) -> np.ndarray:
    """``read_hdr``'s pure-numpy decoder."""
    with open(path, "rb") as f:
        raw = f.read()

    if not (raw.startswith(b"#?RADIANCE") or raw.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # header ends at the first blank line; the resolution line follows
    hdr_end = raw.find(b"\n\n")
    if hdr_end < 0:
        raise ValueError(f"{path}: bad header")
    res_end = raw.find(b"\n", hdr_end + 2)
    res_line = raw[hdr_end + 2 : res_end].decode("ascii", "replace")
    m = re.match(r"-Y (\d+) \+X (\d+)", res_line)
    if not m:
        raise ValueError(f"{path}: unsupported orientation {res_line!r}")
    height, width = int(m.group(1)), int(m.group(2))

    data = memoryview(raw)
    pos = res_end + 1
    rows = np.empty((height, width, 4), np.uint8)
    for y in range(height):
        # new-style RLE scanline marker: 0x02 0x02 then big-endian width
        if (
            width >= 8
            and width < 32768
            and data[pos] == 2
            and data[pos + 1] == 2
            and (data[pos + 2] << 8 | data[pos + 3]) == width
        ):
            rows[y], pos = _read_scanline_rle(data, pos + 4, width)
        else:
            flat = np.frombuffer(data[pos : pos + width * 4], np.uint8)
            rows[y] = flat.reshape(width, 4)
            pos += width * 4

    img = _decode_rgbe(rows)
    if flip_vertical:
        img = img[::-1]
    return np.ascontiguousarray(img)


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) f32 as an uncompressed Radiance .hdr (WriteHDRImage
    analog, asset_loading.cpp:56-59)."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    rgbe = _encode_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode("ascii"))
        f.write(rgbe.tobytes())
