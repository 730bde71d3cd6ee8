"""Device milliseconds a training step of every operation that is not
kernel A, B, C or D (the loss, the parameter packing, fills, Adam)."""

from benchmark.harness.readers import other_ms


def read(ctx):
    return other_ms(ctx, ("kernel_a", "kernel_b", "kernel_c", "kernel_d"))
