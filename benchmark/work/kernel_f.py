"""Kernel F, the combine and accumulate of a multi-sample frame: per
sample an RGBX row (16 B) and six planes (rgb and miss throughput) read,
and the accumulator read and written; 9 operations a sample and 12 a
pixel."""

KERNELS = ("combine_kernel",)
ANCHOR = KERNELS


def work(q: dict) -> tuple:
    n_px, spp = q["n_px"], q["spp"]
    return n_px * (spp * (16 + 6 * 4) + 2 * 12), n_px * (spp * 9 + 12)
