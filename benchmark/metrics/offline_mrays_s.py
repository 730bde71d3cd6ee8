"""Primary rays (W * H * spp) of every frame completed in the window, in
millions, over the window's seconds on the host clock, with every
checkpoint save the window started counted in its seconds (the window
holds whole intervals and ends once each save is whole on disk)."""


def read(ctx):
    w = ctx.window
    return ctx.rays_per_call * w.calls / w.seconds / 1e6
