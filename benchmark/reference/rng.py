"""The tracer's two hash RNGs, bit for bit.

- ``WangRng``: a sequential per-pixel u32 state hashed per draw (Thomas
  Wang's hash), seeded ``(x*1973 + y*9277 + frame*26699) | 1``.
- ``CounterRng``: threefry2x32 (20 rounds) keyed by (pixel, frame,
  sample) with a per-draw counter.

u32 arithmetic runs in int64 tensors masked with ``& 0xFFFFFFFF``. A
draw takes the low 31 bits, converts them to float32, scales by 2^-31,
and returns the result in the generator's ``dtype`` (float32, or
bfloat16 for the lower-precision control).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_M32 = 0xFFFFFFFF
_INV_2_31 = 1.0 / 2147483648.0
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _unit(bits: torch.Tensor, dtype) -> torch.Tensor:
    return ((bits & 0x7FFFFFFF).to(torch.float32) * _INV_2_31).to(dtype)


def wang_hash(seed) -> torch.Tensor:
    s = _u32(seed)
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _M32
    return s ^ (s >> 15)


class WangRng(NamedTuple):
    state: torch.Tensor
    dtype: torch.dtype = torch.float32

    @staticmethod
    def from_pixel(x, y, frame, dtype=torch.float32) -> "WangRng":
        s = _u32(x) * 1973 + _u32(y) * 9277 + _u32(frame) * 26699
        return WangRng((s & _M32) | 1, dtype)

    def next01(self):
        s = wang_hash(self.state)
        return _unit(s, self.dtype), WangRng(s, self.dtype)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key0, key1, ctr0, ctr1):
    """Threefry-2x32 with 20 rounds."""
    k0, k1 = _u32(key0), _u32(key1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (_u32(ctr0) + ks[0]) & _M32
    x1 = (_u32(ctr1) + ks[1]) & _M32
    for block in range(5):
        for r in _ROTATIONS[(block % 2) * 4:(block % 2) * 4 + 4]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _M32
    return x0, x1


class CounterRng(NamedTuple):
    key0: torch.Tensor
    key1: torch.Tensor
    ctr: int
    dtype: torch.dtype = torch.float32

    @staticmethod
    def from_pixel(x, y, frame, sample=0, dtype=torch.float32) -> "CounterRng":
        key0 = (_u32(x) * 1973 + _u32(y) * 9277) & _M32
        key1 = (_u32(frame) * 26699 + _u32(sample) * 40503 + 1) & _M32
        return CounterRng(key0, key1, 0, dtype)

    def next01(self):
        bits, _ = threefry2x32(self.key0, self.key1, self.ctr, 0)
        return (_unit(bits, self.dtype),
                CounterRng(self.key0, self.key1, self.ctr + 1, self.dtype))
