"""Kernel E, the env lookup of one sample of a multi-sample frame: five of
kernel A's planes read (the miss direction and the jitter), one RGBX row
of 16 B written a pixel, and the texels the sample reads read once;
about 40 operations a pixel."""

KERNELS = ("env_lookup_kernel",)
ANCHOR = KERNELS


def work(q: dict) -> tuple:
    n_px = q["n_px"]
    return n_px * (5 * 4 + 16) + 12 * q["texels_per_launch"], 40 * n_px
