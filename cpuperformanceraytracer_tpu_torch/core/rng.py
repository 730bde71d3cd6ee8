"""The renderer's hash RNGs, bit-exact with the JAX package.

Two families, as ``cpuperformanceraytracer_tpu.core.rng``:

- ``WangRng``: a sequential per-pixel u32 state hashed per draw
  (Thomas Wang's hash); seed ``(x*1973 + y*9277 + frame*26699) | 1``.
- ``CounterRng``: threefry2x32 (20 rounds) keyed by (pixel, frame,
  sample) with a per-draw counter, so any draw is addressable.

u32 arithmetic runs in int64 tensors masked with ``& 0xFFFFFFFF``:
torch on the CPU has no u32 add or shift, and a 32x32-bit product fits
in int64. A draw converts the low 31 bits to f32 and scales by 2^-31.

A frame index is an int or a ``DeviceFrame`` (an int the device reads,
plus an offset); ``frame_key`` gives either as the RNGs take it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_M32 = 0xFFFFFFFF
_INV_2_31 = 1.0 / 2147483648.0


def _u32(x):
    """An int64 tensor (or a python int) reduced to its low 32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def wang_hash(seed) -> torch.Tensor:
    """One round of Thomas Wang's 32-bit integer hash."""
    s = _u32(seed)
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _M32
    return s ^ (s >> 15)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 -> f32 in [0, 1): the low 31 bits scaled by 2^-31."""
    return (bits & 0x7FFFFFFF).to(torch.float32) * _INV_2_31


def rand01(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform f32 in [0, 1) and the advanced state."""
    state = wang_hash(state)
    return bits_to_unit(state), state


def signed_rand01(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform f32 in [-1, 1) and the advanced state: the u32 read as a
    signed int32, scaled by 2^-31."""
    state = wang_hash(torch.as_tensor(state, dtype=torch.int64))
    signed = state - ((state >> 31) << 32)
    return signed.to(torch.float32) * _INV_2_31, state


def pixel_seed(x, y, frame) -> torch.Tensor:
    """``(x*1973 + y*9277 + frame*26699) | 1`` in wrapping u32."""
    s = _u32(x) * 1973 + _u32(y) * 9277 + _u32(frame) * 26699
    return (s & _M32) | 1


class WangRng(NamedTuple):
    state: torch.Tensor

    @staticmethod
    def from_pixel(x, y, frame) -> "WangRng":
        return WangRng(pixel_seed(x, y, frame))

    def next01(self) -> Tuple[torch.Tensor, "WangRng"]:
        v, s = rand01(self.state)
        return v, WangRng(s)


_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key0, key1, ctr0, ctr1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds (the jax.random construction)."""
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


def counter_rand01(key0, key1, ctr0, ctr1) -> torch.Tensor:
    """One uniform [0,1) f32 addressed by (key, counter)."""
    bits, _ = threefry2x32(key0, key1, ctr0, ctr1)
    return bits_to_unit(bits)


class CounterRng(NamedTuple):
    key0: torch.Tensor
    key1: torch.Tensor
    ctr: int

    @staticmethod
    def from_pixel(x, y, frame, sample=0) -> "CounterRng":
        """The stream of pixel (x, y) for one (frame, sample)."""
        key0 = (_u32(x) * 1973 + _u32(y) * 9277) & _M32
        key1 = (_u32(frame) * 26699 + _u32(sample) * 40503 + 1) & _M32
        return CounterRng(key0, key1, 0)

    def next01(self) -> Tuple[torch.Tensor, "CounterRng"]:
        v = counter_rand01(self.key0, self.key1, self.ctr, 0)
        return v, CounterRng(self.key0, self.key1, self.ctr + 1)


class DeviceFrame(NamedTuple):
    """The frame index ``base[0] + offset``, read on the device: ``base``
    is a (1,) int32 tensor, ``offset`` an int. A CUDA graph bakes the
    offset in and replays with the frame the host wrote into ``base``."""

    base: torch.Tensor
    offset: int


def frame_key(frame):
    """The frame as the RNGs take it: an int, or for a ``DeviceFrame`` a
    (1,) int64 tensor (no read on the host)."""
    if isinstance(frame, DeviceFrame):
        return frame.base.to(torch.int64) + frame.offset
    return int(frame)
