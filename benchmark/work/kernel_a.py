"""Kernel A, the forward megakernel: one launch renders one sample of
every pixel into 12 float32 planes. Bytes: the planes written (the scene
tables are a few kB). Operations: every live path segment tests every
object and shades, and each pixel casts its camera ray."""

from benchmark.work.common import FLOPS_CAMERA, segment_flops

KERNELS = ("render_planes_kernel",)
ANCHOR = KERNELS


def work(q: dict) -> tuple:
    n_px = q["n_px"]
    return (12 * 4 * n_px,
            q["live_per_launch"] * segment_flops(q) + n_px * FLOPS_CAMERA)
