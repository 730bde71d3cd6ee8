"""Kernel C, the path-replay adjoint of one training step's sample. Bytes:
the six cotangent planes read and the table cotangents written once.
Operations: the forward replay of every live segment (the last segment
of each path only once, its adjoint reusing the replay), each live
segment's adjoint, and the camera ray and its adjoint per pixel."""

from benchmark.work.common import (
    FLOPS_ADJOINT,
    FLOPS_CAMERA,
    FLOPS_CAMERA_ADJ,
    segment_flops,
    table_cells,
)

KERNELS = ("bwd_tables_kernel",)
ANCHOR = KERNELS


def work(q: dict) -> tuple:
    n_px, live = q["n_px"], q["live_per_launch"]
    flops = ((2 * live - n_px) * segment_flops(q) + live * FLOPS_ADJOINT
             + n_px * (FLOPS_CAMERA + FLOPS_CAMERA_ADJ))
    return 6 * 4 * n_px + 4 * table_cells(q), flops
