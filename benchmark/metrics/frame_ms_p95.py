"""The 95th percentile of the time of every frame of the window, from CUDA
events recorded after each frame as the host enqueues them."""

from benchmark.harness.window import percentile


def read(ctx):
    return percentile(ctx.window.call_ms, 95.0)
