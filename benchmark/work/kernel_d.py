"""Kernel D with its sort, the env texels' gradient of one training step's
sample: per pixel the colour cotangent (12 B), the texel index (8 B) and
the miss throughput (12 B) read and the throughput's cotangent (12 B)
written; the three texel planes read once and their gradient written
once; about 9 operations a pixel. Its time is that of its two kernels
and the library's radix sort between them, per launch (a sample)."""

KERNELS = ("env_runs_kernel", "texel_sums_kernel", "RadixSort")
ANCHOR = ("env_runs_kernel",)


def work(q: dict) -> tuple:
    n_px = q["n_px"]
    return n_px * (12 + 8 + 12 + 12) + 2 * 3 * 4 * q["n_texels"], 9 * n_px
