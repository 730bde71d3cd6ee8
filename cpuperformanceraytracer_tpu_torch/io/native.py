"""ctypes bindings for the repo's native IO library (``native/librgbe.so``).

Counterpart of ``cpuperformanceraytracer_tpu.io.native``: the C++ RGBE
decoder and BMP encoder of ``native/rgbe.cpp``, loaded lazily at the
first call. Every entry point returns None or False when the library is
absent, and its callers (``texture/hdr.read_hdr``, ``io/image.write_bmp``)
then take their pure-numpy path, so the native build is an optimisation,
never a requirement. Build it with ``make -C native``. A host codec, not
a GPU kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

# <repo>/native/librgbe.so, beside the package
LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "librgbe.so"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it is not built (looked up once;
    set ``_TRIED`` False to look again)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.rgbe_read_header.restype = ctypes.c_int
    lib.rgbe_read_header.argtypes = [
        ctypes.c_char_p, ctypes.c_long, c_int_p, c_int_p,
        ctypes.POINTER(ctypes.c_long)]
    lib.rgbe_decode.restype = ctypes.c_int
    lib.rgbe_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.bmp_encode.restype = ctypes.c_long
    lib.bmp_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    _LIB = lib
    return _LIB


def read_hdr_native(path: str, flip_vertical: bool = True):
    """Native .hdr decode: (H, W, 3) f32, or None if the library is absent
    or rejects the file."""
    lib = get_lib()
    if lib is None:
        return None
    raw = Path(path).read_bytes()
    w, h, off = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    if lib.rgbe_read_header(raw, len(raw), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(off)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.float32)
    if lib.rgbe_decode(raw, len(raw), off.value, w.value, h.value,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
        return None
    return np.ascontiguousarray(out[::-1]) if flip_vertical else out


def write_bmp_native(path: str, rgb: np.ndarray) -> bool:
    """Native BMP encode and write of (H, W, 3) u8; False if the library
    is absent or the encode fails."""
    lib = get_lib()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    cap = 54 + ((w * 3 + 3) & ~3) * h
    out = np.empty(cap, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    n = lib.bmp_encode(rgb.ctypes.data_as(u8), w, h, out.ctypes.data_as(u8),
                       cap)
    if n <= 0:
        return False
    Path(path).write_bytes(out[:n].tobytes())
    return True
