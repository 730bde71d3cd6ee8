"""The 95th percentile of the time of every frame of the window, from CUDA
events recorded after each frame as the host enqueues them. In a world
of ranks a frame ends when its slowest rank's rows end: the tail is
taken over each frame's longest time on any rank (every rank makes the
same calls, so their times line up)."""

from benchmark.harness.window import percentile


def read(ctx):
    return percentile([max(c) for c in zip(*ctx.ranks)], 95.0)
