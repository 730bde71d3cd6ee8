"""Kernel A's lane use, in percent: the lanes that ran a bounce segment
over the lane slots of its warp iterations, from the program's lane
counter over the program-traced pass's calls."""

from benchmark.harness.program import lane_use


def read(ctx):
    return lane_use(ctx, "kernel_a")
