"""Mean host milliseconds that the render loop spends inside a call of
the program's checkpoint save in the measured window (the device-to-host
copy of the accumulator and the file written), timed around each call by
the ``checkpointed`` kind and handed over with its check's counts."""


def read(ctx):
    return ctx.work.get("save_ms")
