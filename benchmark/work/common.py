"""The yardstick of the kernels' rooflines: the card's published peaks and
the bound of a piece of work.

A kernel's bound is the larger of its bytes over the HBM rate and its
float32 operations over the CUDA cores' rate (an FMA counts 2). The
counts come from the work the algorithm needs for the inputs, counted by
the benchmark from the reference's own run (live path segments, texels
read), never from the program's counters, so a roofline reads the same
work whatever implements the kernel.
"""

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, float32 FLOP/s outside
# the tensor cores; both at the card's full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12

# float32 operations the bounce loop needs unconditionally (add, sub,
# mul, div, sqrt, min, max, transcendental: 1 each; the integer RNG
# work, comparisons and selects are not counted, so the bound stays a
# lower bound)
FLOPS_QUAD = 44            # one ray-quad test
FLOPS_SPHERE = 19          # one ray-sphere test
FLOPS_SHADE = 200          # the rest of a segment
FLOPS_CAMERA = 29          # the camera ray and the output sum, per pixel
FLOPS_ADJOINT = 110        # a segment's adjoint
FLOPS_CAMERA_ADJ = 27      # the camera ray's adjoint, per pixel


def bound_ms(nbytes: float, flops: float) -> float:
    """The least milliseconds the card needs to move ``nbytes`` and do
    ``flops`` float32 operations."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3


def segment_flops(q: dict) -> int:
    """Operations of one path segment: every object tested, then shaded."""
    return (FLOPS_QUAD * q["n_quads"] + FLOPS_SPHERE * q["n_spheres"]
            + FLOPS_SHADE)


def table_cells(q: dict) -> int:
    """Cells of the four scene tables (quads 25, spheres 5, materials 17,
    camera 8)."""
    return 25 * q["n_quads"] + 5 * q["n_spheres"] + 17 * q["n_materials"] + 8
