"""K steps in one dispatch on the card: a CUDA graph whose steps read
their frame from a device int.

The JAX package fuses K steps into one ``lax.scan``. Here one
``torch.cuda.CUDAGraph`` holds them: step i renders frame
``DeviceFrame(base, i)``, so the capture bakes the offset i in and every
replay renders the frame the host wrote into ``base`` with ``fill_`` (a
kernel, not a copy from the host). ``make_grad_step_k`` and
``make_train_step_k`` build on it; on the CPU they run the K steps in a
loop, with int frames. The graph keeps what its capture made
(``utils/profiling.capturing``): the kernel launches its capture made,
counted at each replay apart from the wrappers' own counts
(``profiling.replayed_launches``), and the phase events of a capture
made with tracing on, timed at each replay.
"""

from __future__ import annotations

from typing import Callable

import torch

from cpuperformanceraytracer_tpu_torch.core.rng import DeviceFrame
from cpuperformanceraytracer_tpu_torch.utils import profiling


class StepGraph:
    """One CUDA graph of ``steps(frames)`` over K device frames.

    ``steps`` runs once on a side stream (it builds the kernels, fills
    the occupancy caches and warms the allocator), then the capture
    records it; its inputs are tensors that stay in place. A capture that
    fails raises: nothing falls back to an ungraphed run."""

    def __init__(self, steps: Callable, k: int, device):
        self.base = torch.zeros(1, dtype=torch.int32, device=device)
        frames = [DeviceFrame(self.base, i) for i in range(k)]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            steps(frames)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with profiling.capturing() as self.made, torch.cuda.graph(self.graph):
            self.out = steps(frames)

    def replay(self, frame0: int):
        """The K steps at frames frame0 ... frame0 + K - 1; returns the
        captured outputs, which the next replay overwrites."""
        self.base.fill_(int(frame0))
        self.graph.replay()
        profiling.replayed(self.made)
        return self.out
