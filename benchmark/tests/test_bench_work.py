"""The roofline's work counts against values worked by hand for a tiny
scene: one quad, one sphere, two materials, a 2x2 image, two samples a
frame, eight texels."""

import pytest
import torch

from benchmark.harness.spec import load_module
from benchmark.reference.tracer import render_planes, tables
from benchmark.work.common import bound_ms, segment_flops, table_cells

Q = {"n_quads": 1, "n_spheres": 1, "n_materials": 2, "n_px": 4,
     "live_per_launch": 6, "n_texels": 8, "texels_per_launch": 3, "spp": 2}

# (bytes, operations) worked by hand from each file's docstring:
# a segment is 44 + 19 + 200 = 263 operations; the tables hold
# 25 + 5 + 2 * 17 + 8 = 72 cells
HAND = {
    "kernel_a": (12 * 4 * 4, 6 * 263 + 4 * 29),                  # 192, 1694
    "kernel_b": (17 * 4 * 4 + 12 * 8, 10 * 4),                   # 368, 40
    "kernel_c": (6 * 4 * 4 + 4 * 72,
                 (2 * 6 - 4) * 263 + 6 * 110 + 4 * (29 + 27)),   # 384, 2988
    "kernel_d": (4 * 44 + 2 * 3 * 4 * 8, 9 * 4),                 # 368, 36
    "kernel_e": (4 * 36 + 12 * 3, 40 * 4),                       # 180, 160
    "kernel_f": (4 * (2 * 40 + 24), 4 * (2 * 9 + 12)),           # 416, 120
}


def test_segment_and_table_counts():
    assert segment_flops(Q) == 263
    assert table_cells(Q) == 72


@pytest.mark.parametrize("kernel", sorted(HAND))
def test_kernel_work_by_hand(kernel):
    assert load_module("work", kernel).work(Q) == HAND[kernel]


def test_bound_takes_the_larger_time():
    assert bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert bound_ms(0, 67e9) == pytest.approx(1.0)
    assert bound_ms(3.35e9, 134e9) == pytest.approx(2.0)


@pytest.mark.parametrize("kind,rng,spp,want", [
    ("progressive", "wang", 1, {"kernel_a": 1, "kernel_b": 1}),
    ("progressive", "counter", 16, {"kernel_a": 16, "kernel_e": 16,
                                    "kernel_f": 1}),
    ("train", "counter", 1, {"kernel_a": 16, "kernel_b": 16, "kernel_c": 16,
                             "kernel_d": 16}),
    ("train", "counter", 2, {"kernel_a": 32, "kernel_b": 32, "kernel_c": 32,
                             "kernel_d": 32}),
])
def test_launches_per_call(kind, rng, spp, want):
    opts = {"rng": rng, "spp": spp}
    traffic = {"kind": kind, "steps_per_dispatch": 16}
    assert load_module("kinds", kind).launches(opts, traffic) == want


def _tiny_scene(forward_z):
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    mats = {"albedo": f([[0.7] * 3, [0.5] * 3]), "emissive": f([[0.0] * 3] * 2),
            "specular_chance": f([0.0, 0.0]),
            "specular_roughness": f([0.0, 0.0]),
            "specular_color": f([[0.0] * 3] * 2), "ior": f([1.0, 1.0]),
            "refraction_chance": f([0.0, 0.0]),
            "refraction_roughness": f([0.0, 0.0]),
            "refraction_color": f([[0.0] * 3] * 2)}
    return {"quads": f([[[-20, -20, -10], [20, -20, -10], [20, 20, -10],
                         [-20, 20, -10]]]),
            "quad_material": torch.tensor([0]),
            "centers": f([[0.0, 0.0, -100.0]]), "radii": f([0.5]),
            "sphere_material": torch.tensor([1]), "materials": mats,
            "camera": {"position": [0.0, 0.0, 0.0], "distance": 1.0,
                       "forward_z": forward_z}}


@pytest.mark.parametrize("forward_z,want", [(1.0, [4, 0]), (-1.0, [4, 4])])
def test_live_segments_by_hand(forward_z, want):
    """A 2x2 image, one bounce, no roulette: looking away from the quad
    every path misses at once; looking at it (a wide quad straight ahead)
    every path hits it and lives into the second segment."""
    opts = {"width": 2, "height": 2, "spp": 1, "bounces": 1, "rng": "counter",
            "roulette": "off", "ambient": [0.1, 0.1, 0.1], "jitter": False}
    live = []
    render_planes(tables(_tiny_scene(forward_z), opts), opts, 0, live=live)
    assert live == want
