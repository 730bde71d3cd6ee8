"""Device milliseconds a training step of the phase ``step.adam``
(Adam's update): between the program's two boundary events of the phase
in the graph's last replay of the program-traced pass, the gaps between
its operations included."""

from benchmark.harness.program import phase_ms


def read(ctx):
    return phase_ms(ctx, "step.adam")
