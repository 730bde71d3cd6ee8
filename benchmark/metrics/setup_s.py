"""Seconds from the start of the process to the window's first call:
imports, the card, the inputs, the kernels' build or load, warm-up, and
for training the target frame and the capture of the K-step graph."""


def read(ctx):
    return ctx.setup_s
