"""Kernel E's share of its roofline, in percent: its bound (the work
counted in ``benchmark/work/kernel_e.py``) over its device time in the
trace."""

from benchmark.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "kernel_e")
