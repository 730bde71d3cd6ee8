"""Host milliseconds of the program's ``driver.frame`` span (one
``OfflineRenderer.step()``), the mean over the program-traced pass's
frames."""

from benchmark.harness.program import host_ms


def read(ctx):
    return host_ms(ctx, "driver.frame")
