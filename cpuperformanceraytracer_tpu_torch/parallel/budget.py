"""Communication budget of the sharded training step.

Counterpart of ``cpuperformanceraytracer_tpu.parallel.budget``, with its
formula. The collectives of one value-and-grad step over a (px, spp)
mesh (``parallel/shard.py``):

  1. the image all-reduce over "spp" (the partial-sample frames), and in
     the backward the all-reduce of its cotangent: the (3, H/n_px, W)
     rows cross twice a step; none when spp is not sharded;
  2. the loss: three partial sums all-reduced;
  3. the gradients: every trained parameter, once, in one flat
     all-reduce.

``parallel.shard.comm_elements`` counts what the collectives of a run
move, and the tests hold one step's count to this model.
"""

from __future__ import annotations

from typing import Iterable


def training_step_comm_elements(height: int, width: int, n_px: int,
                                n_spp: int,
                                param_sizes: Iterable[int]) -> int:
    """Modelled f32 elements all-reduced per fwd+bwd step."""
    image = 2 * 3 * (height // n_px) * width if n_spp > 1 else 0
    grads = sum(param_sizes)
    loss = 3
    return image + grads + loss


def training_step_comm_bytes(height: int, width: int, n_px: int,
                             n_spp: int,
                             param_sizes: Iterable[int]) -> int:
    return 4 * training_step_comm_elements(height, width, n_px, n_spp,
                                           param_sizes)
