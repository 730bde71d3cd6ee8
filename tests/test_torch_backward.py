"""Kernel C (the path-replay adjoint): its plain version vs the JAX
adjoint ``_bwd_tables`` (Pallas in interpret mode) on identical numpy
tables and cotangents, the gradient policy of the plain kernel A, and
kernel C's CUDA source compiled by the host C++ compiler.

Interpret mode is slow on the CPU (25-35 s a call), so each JAX
reference runs once, in a module-scoped fixture. Tolerance rtol 2e-3 and
atol 2e-3 of the table's largest reference cotangent, as
``tests/test_diff_pallas.py``: the two sides sum over pixels in other
orders, and the JAX kernel normalises the traced sphere normal where the
port scales by 1/r (equal derivatives on the sphere, other roundings).
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import beer_scene, jax_cfg, port_cfg
from cpuperformanceraytracer_tpu.kernels.backward import (
    _bwd_tables,
    bake_base_tables,
)
from cpuperformanceraytracer_tpu.kernels.megakernel import (
    pack_camera as jax_pack_camera,
    pack_scene as jax_pack_scene,
)
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu.scene.camera import make_camera
from cpuperformanceraytracer_tpu.scene.presets import cornell_box_scene
from cpuperformanceraytracer_tpu.scene.types import Material
from cpuperformanceraytracer_tpu_torch.kernels.backward import (
    OUT_PLANES,
    bwd_tables,
    bwd_tables_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    _aspect,
    pack_tables,
    render_planes_reference,
)

FRAME = 1
TABLES = ("quad", "sphere", "material", "camera")
BEER = dict(width=128, height=32, bounces=2, rng="counter", jitter=True,
            roulette="off", env_mode="equirect", env_sampling="stochastic")
CORNELL = dict(scene="cornell_box", width=128, height=16, bounces=2,
               rng="counter", jitter=True, roulette="off", env_mode="none",
               ambient=(0.1, 0.1, 0.1), env_flip_xz=False)


def _jax_case(jscene, jcam, jcfg, trained):
    """(port cfg, port tables, cot6, JAX cotangent tables)."""
    jtables = (*jax_pack_scene(jscene), jax_pack_camera(jcam, jcfg))
    rng = np.random.RandomState(0)
    cot6 = rng.randn(6, jcfg.height, jcfg.width).astype(np.float32)
    want = _bwd_tables(jcfg, *jtables, FRAME, 0,
                       tuple(jnp.asarray(c) for c in cot6), trained=trained,
                       baked=bake_base_tables(jscene, jcam, jcfg))
    tables = tuple(torch.from_numpy(np.asarray(t, np.float32).copy())
                   for t in jtables)
    return (port_cfg(jcfg), tables, torch.from_numpy(cot6),
            [np.asarray(w) for w in want])


@pytest.fixture(scope="module")
def beer():
    jscene, jcam = beer_scene(SceneBuilder, Material, make_camera)
    return _jax_case(jscene, jcam, jax_cfg(**BEER), None)


@pytest.fixture(scope="module")
def cornell():
    jscene, jcam = cornell_box_scene()
    return _jax_case(jscene, jcam, jax_cfg(**CORNELL),
                     frozenset({"albedo", "emissive"}))


def _close(got, want, what):
    assert np.abs(want).max() > 0.0, f"{what}: the reference is all zero"
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * scale,
                               err_msg=what)


@pytest.mark.parametrize("table", [1, 2, 3], ids=TABLES[1:])
def test_beer_tables_match_jax(beer, table):
    """The strict check of the sphere, camera and refraction adjoint."""
    cfg, tables, cot6, want = beer
    got = bwd_tables(tables, cfg, FRAME, 0, cot6)
    _close(got[table].numpy(), want[table], TABLES[table])


def test_beer_quad_cotangent_is_zero_on_both_sides(beer):
    """At 2 bounces no path reaches the floor's geometry through Beer
    absorption (a diffuse hit's geometry cotangent is exactly 0), so the
    quad table is zero in the reference and must be zero here."""
    cfg, tables, cot6, want = beer
    assert not np.any(want[0])
    assert not torch.any(bwd_tables(tables, cfg, FRAME, 0, cot6)[0])


def test_cornell_trained_columns_match_jax(cornell):
    """Partially trained JAX kernel ({albedo, emissive}): those columns
    and the ambient; cells JAX did not train are not compared."""
    cfg, tables, cot6, want = cornell
    got = bwd_tables(tables, cfg, FRAME, 0, cot6)
    _close(got[2][:, 0:3].numpy(), want[2][:, 0:3], "albedo")
    _close(got[2][:, 3:6].numpy(), want[2][:, 3:6], "emissive")
    _close(got[3][5:8].numpy(), want[3][5:8], "ambient")


def test_estimator_weights_detached():
    """The gradient policy: the lottery weight and the roulette boost are
    detached, so specular_chance (col 6) and refraction_chance (col 12)
    reach the image only through booleans and get exactly 0."""
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    cfg = RenderConfig(width=64, height=16, bounces=3, rng="counter",
                       backend="torch")
    tables = pack_tables(*scene_by_name("glass_spheres"), cfg, "cpu")
    cot6 = torch.from_numpy(
        np.random.RandomState(3).randn(6, 16, 64).astype(np.float32))
    d_mat = bwd_tables_reference(tables, cfg, 0, 0, cot6)[2]
    assert torch.isfinite(d_mat).all()
    assert torch.all(d_mat[:, 6] == 0) and torch.all(d_mat[:, 12] == 0)
    assert d_mat[:, 0:3].abs().max() > 0


def test_wrapper_contract():
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    cfg = RenderConfig(width=32, height=8, bounces=1, rng="counter",
                       backend="torch")
    tables = pack_tables(*scene_by_name("glass_spheres"), cfg, "cpu")
    cot6 = torch.ones((6, 8, 32))
    before = bwd_tables.launches
    got = bwd_tables(tables, cfg, 0, 0, cot6)
    assert bwd_tables.launches == before  # the CPU path launches nothing
    for g, t in zip(got, tables):
        assert g.shape == t.shape and g.dtype == torch.float32
    with pytest.raises(ValueError, match="counter"):
        bwd_tables(tables, cfg.replace(rng="wang"), 0, 0, cot6)
    with pytest.raises(ValueError, match="unsupported device"):
        bwd_tables(tuple(t.to("meta") for t in tables), cfg, 0, 0, cot6)


# ---- kernel C's CUDA source on the host ------------------------------------
#
# bounce.cuh and backward.cu are plain C++ outside their CUDA-only parts:
# this harness compiles them with the host compiler (no FMA contraction)
# and drives kernel C's steps (start_pixel, then step_segment and
# step_finish until the pixel is done) over every pixel, summing each step's table cotangents in
# float64.

HARNESS = r"""
#include "backward.cu"
#include <string.h>
#include <vector>


extern "C" int host_bwd_tables(const float* q, int nq, const float* s, int ns,
                               const float* m, int nm, const float* c,
                               const float* cot6, double* cells, int width,
                               int height, int frame, int bounces, int env_draws,
                               int env_none, int roulette, int zangle, int jitter,
                               float aspect) {
    Params P{width, height, frame, 0, 1, bounces, nq, ns, nm, 1, env_draws,
             env_none, roulette, zangle, jitter, aspect, 1.0f};
    std::vector<float> sm(scene_smem_floats(nq, ns, nm));
    float* quads = sm.data();
    float* sph = quads + nq * QUAD_COLS;
    float* inv_r = sph + ns * SPH_COLS;
    float* mats = inv_r + ns;
    float* cam = mats + nm * MAT_COLS;
    memcpy(quads, q, sizeof(float) * nq * QUAD_COLS);
    memcpy(sph, s, sizeof(float) * ns * SPH_COLS);
    memcpy(mats, m, sizeof(float) * nm * MAT_COLS);
    memcpy(cam, c, sizeof(float) * CAM_COLS);
    for (int i = 0; i < ns; ++i) inv_r[i] = (float)(1.0 / (double)s[i * SPH_COLS + 3]);
    const Cells C = cell_layout(nq, ns, nm);
    const size_t n = (size_t)width * height;
    std::vector<float> stack((bounces + 1) * 9);
    const Stack st{stack.data(), 1};
    int live = 0;
    for (int row = 0; row < height; ++row)
        for (int col = 0; col < width; ++col) {
            float cot[6];
            for (int k = 0; k < 6; ++k) cot[k] = cot6[k * n + (size_t)row * width + col];
            // one lane's sequence of steps, as the kernel drives it
            Lane L;
            start_pixel(L, P, cam, col, row, cot, st);
            bool done = false;
            while (!done) {
                const bool replay = L.replay;
                Contrib c;
                clear(c);
                Path q;
                Seg s;
                step_segment(L, P, quads, sph, inv_r, mats, cam, st, q, s);
                done = step_finish(L, P, quads, sph, inv_r, cam, C, st, q, s, c);
                add_contrib(cells, C, c);
                live += replay;
            }
        }
    return live;
}
"""


@pytest.fixture(scope="module")
def host_kernel_c(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    from cpuperformanceraytracer_tpu_torch.kernels._build import CSRC_DIR

    d = tmp_path_factory.mktemp("host_kernel_c")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{CSRC_DIR}", "-x", "c++", str(d / "harness.cpp"),
                    "-o", str(d / "libharness.so")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_bwd_tables.argtypes = [P, I, P, I, P, I, P, P, P] + [I] * 9 + [
        ctypes.c_float]
    lib.host_bwd_tables.restype = I
    return lib


def _host_case(name):
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    from torch_port_helpers import port_beer_scene

    base = dict(rng="counter", backend="torch")
    if name == "beer_v4":
        return port_beer_scene(), RenderConfig(
            width=64, height=32, bounces=4, roulette="v4_quirk", **base)
    if name == "cornell_terminate_zangle":
        return scene_by_name("cornell_box"), RenderConfig(
            width=64, height=32, bounces=3, roulette="terminate",
            unit_vector_sampler="zangle", env_mode="none", **base)
    return scene_by_name("glass_spheres"), RenderConfig(
        width=64, height=32, bounces=8, **base)


@pytest.mark.parametrize("name", ["beer_v4", "cornell_terminate_zangle",
                                  "glass_8_bounces"])
def test_kernel_c_source_matches_plain_on_host(host_kernel_c, name):
    """csrc/backward.cu's adjoint (hand-derived) vs autograd through the
    plain kernel A, on the same pixels: rtol 1e-4, atol 1e-4 of the
    table's largest cotangent (summation order; libm vs torch rounding)."""
    (scene, cam), cfg = _host_case(name)
    tables = pack_tables(scene, cam, cfg, "cpu")
    q, s, m, c = tables
    cot6 = torch.from_numpy(np.random.RandomState(5).randn(
        6, cfg.height, cfg.width).astype(np.float32))
    cells = np.zeros(sum(t.numel() for t in tables), np.float64)
    env_draws = cfg.env_mode != "none" and cfg.env_sampling == "stochastic"
    live = host_kernel_c.host_bwd_tables(
        q.data_ptr(), q.shape[0], s.data_ptr(), s.shape[0], m.data_ptr(),
        m.shape[0], c.data_ptr(), cot6.data_ptr(), cells.ctypes.data,
        cfg.width, cfg.height, FRAME, cfg.bounces, int(env_draws),
        int(cfg.env_mode == "none"),
        {"off": 0, "terminate": 1, "v4_quirk": 2}[cfg.roulette],
        int(cfg.unit_vector_sampler == "zangle"), int(cfg.jitter),
        _aspect(cfg))
    counted = []
    render_planes_reference(tables, cfg, FRAME, live_segments=counted)
    assert live == sum(counted)  # the replay stops where kernel A does
    want = bwd_tables_reference(tables, cfg, FRAME, 0, cot6)
    off = 0
    for tbl, t, w in zip(TABLES, tables, want):
        got = cells[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
        w = w.double().numpy()
        if tbl == "material" or np.any(w):
            assert np.abs(w).max() > 0.0, tbl
            np.testing.assert_allclose(got, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=tbl)
        else:
            assert not np.any(got), tbl


def test_out_planes_are_rgb_and_miss_throughput():
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import PLANE_NAMES

    assert [PLANE_NAMES[i] for i in OUT_PLANES] == [
        "r", "g", "b", "mt_x", "mt_y", "mt_z"]
