"""Faults the benchmark's tests plant in the program: in its gradient,
and in one rank of a world."""

import os
import sys
import time
import types
from pathlib import Path

import torch

from cpuperformanceraytracer_tpu_torch.render import driver


class ScaledBackward(torch.autograd.Function):
    """The identity forward; the backward scales the cotangent."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def backward_scaled(render, factor):
    """``render`` with its forward as it is and its gradient scaled by
    ``factor``."""
    def scaled(*args, **kwargs):
        return ScaledBackward.apply(render(*args, **kwargs), factor)
    return scaled


def follower_fault(fault, at_rank, pid_dir, rank):
    """Run first in each follower of a world (``world.FOLLOWER_SETUP``):
    write the follower's pid to ``<pid_dir>/<rank>.pid`` and, on rank
    ``at_rank``, plant ``fault`` in the program's frame from frame 3 on,
    past the warm-up's frames: ``idle`` (the frame leaves the accumulator
    as it was), ``raise`` (it raises), ``silent`` (it never returns),
    ``slow`` (it sleeps 150 ms, then renders) or ``flax`` (it loads a
    module named ``flax``, then renders)."""
    Path(pid_dir, f"{rank}.pid").write_text(str(os.getpid()))
    if rank != at_rank:
        return
    step = driver.OfflineRenderer.step

    def faulty(self):
        if self.frame < 3:
            return step(self)
        if fault == "raise":
            raise RuntimeError("a fault planted in this rank's frame")
        if fault == "silent":
            time.sleep(3600)
        if fault == "slow":
            time.sleep(0.15)
            return step(self)
        if fault == "flax":
            sys.modules.setdefault("flax", types.ModuleType("flax"))
            return step(self)
        self.frame += 1

    driver.OfflineRenderer.step = faulty
