"""What the per-layer metrics' readers share: a kernel's roofline share
from the trace and the work counts, the device's idle share, and the
device time of the small operations. A reader that finds nothing to read
returns None, and the metric is left out of the result."""

from __future__ import annotations

from benchmark.harness.spec import load_module
from benchmark.work.common import bound_ms


def kernel_ms(ctx, kernel: str):
    """Device ms of one launch (or, for a kernel counted per step, one
    step) of ``kernel``, from the launches the trace recorded."""
    if ctx.trace is None:
        return None
    w = load_module("work", kernel)
    found = ctx.trace.matching(w.KERNELS)
    launches = sum(n for n, _ in ctx.trace.matching(w.ANCHOR).values())
    if not found or not launches:
        return None
    return sum(t for _, t in found.values()) * 1e3 / launches


def roofline(ctx, kernel: str):
    """Percent of the kernel's bound: bound ms over device ms."""
    ms = kernel_ms(ctx, kernel)
    if not ms:
        return None
    nbytes, flops = load_module("work", kernel).work(ctx.work)
    return 100.0 * bound_ms(nbytes, flops) / ms


def idle_share(ctx):
    """Percent of the traced window (the first device operation's start
    to the last's end) in which no operation ran on the device: 1 -
    busy_s / window_s, both read from the trace."""
    if ctx.trace is None or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def enqueue_ms(ctx):
    """Host ms to enqueue one call while the stream is held full (the
    call returns before the device runs it)."""
    return None if ctx.held is None else ctx.held[1]


def other_ms(ctx, kernels):
    """Device ms a training step of every operation in the trace that is
    not one of ``kernels`` (names of ``benchmark/work`` files)."""
    if ctx.trace is None:
        return None
    patterns = tuple(p for k in kernels
                     for p in load_module("work", k).KERNELS)
    by_name = ctx.trace.by_name()
    other = sum(t for name, (_, t) in by_name.items()
                if not any(p in name for p in patterns))
    steps = ctx.trace.calls * ctx.steps_per_call
    return other * 1e3 / steps
