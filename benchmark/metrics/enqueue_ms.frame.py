"""Host milliseconds to enqueue one call of the window's entry point with
the stream held full, so the call never waits for the device."""

from benchmark.harness.readers import enqueue_ms


def read(ctx):
    return enqueue_ms(ctx)
