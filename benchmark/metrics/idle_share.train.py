"""The device's idle share of the traced calls, in percent: 1 - (the
seconds in which a device operation ran) / (the first operation's start
to the last one's end), both from the trace."""

from benchmark.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
