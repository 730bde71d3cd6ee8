"""Kernel B, the env resolve and accumulate of a one-sample frame: it
reads 11 of kernel A's planes and the env map once, and reads and writes
the (3, H, W) accumulator; about 10 operations a pixel."""

KERNELS = ("env_accumulate_kernel",)
ANCHOR = KERNELS


def work(q: dict) -> tuple:
    n_px = q["n_px"]
    return (11 + 6) * 4 * n_px + 3 * 4 * q["n_texels"], 10 * n_px
