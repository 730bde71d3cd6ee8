"""Segment sum in a fixed order: the env-texel gradient's reduction.

Counterpart of ``cpuperformanceraytracer_tpu.diff.segsum``, which sums
``d_tex[idx[p]] += v[p]`` with a sort, a prefix sum and a gather because
scatters serialise on a TPU. JAX computes it with XLA ops outside any
Pallas kernel, so here it is plain torch on the inputs' device: a stable
sort of the indices, then each run of equal indices summed in sorted
order, as the difference of a float64 prefix sum at the run's ends
(rounded once to f32), so every call gives the same bits.

The training step does not call this function: kernel D
(``kernels/env_backward.py``, ``csrc/env_backward.cu``) fuses the same
sorted segment sum with the env cotangents.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def segment_sum_sorted(idx: torch.Tensor, values: Sequence[torch.Tensor],
                       num_segments: int) -> Tuple[torch.Tensor, ...]:
    """Sum each 1-D tensor of ``values`` into ``num_segments`` bins.

    idx: (P,) int in [0, num_segments); values: (P,) f32 tensors.
    Returns a tuple of (num_segments,) f32 tensors, one per value: bin t
    holds the sum of the values whose index is t (0 where none is)."""
    idx = idx.reshape(-1).to(torch.int64)
    keys, order = torch.sort(idx, stable=True)
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = keys[1:] != keys[:-1]
    ends = last.nonzero().squeeze(1)
    out = []
    for v in values:
        prefix = torch.cumsum(v.reshape(-1)[order].to(torch.float64), 0)
        at_end = prefix[ends]
        sums = torch.diff(at_end, prepend=at_end.new_zeros(1))
        seg = torch.zeros(num_segments, dtype=torch.float64, device=v.device)
        seg[keys[ends]] = sums
        out.append(seg.to(torch.float32))
    return tuple(out)
