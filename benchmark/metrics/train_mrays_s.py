"""Primary rays (W * H * spp) of every training step completed in the
window, in millions, over the window's seconds on the host clock."""


def read(ctx):
    w = ctx.window
    return ctx.rays_per_call * w.calls / w.seconds / 1e6
