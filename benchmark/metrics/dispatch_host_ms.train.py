"""Host milliseconds of the program's ``dispatch`` span (one call of
``make_train_step_k``'s K steps: the frame's fill, the graph's replay and
the losses' copy), the mean over the program-traced pass's dispatches."""

from benchmark.harness.program import host_ms


def read(ctx):
    return host_ms(ctx, "dispatch")
