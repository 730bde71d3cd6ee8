"""Faults the benchmark's tests plant in the program's gradient."""

import torch


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
