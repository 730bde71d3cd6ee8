"""The slice end to end: the port's ``OfflineRenderer(backend="torch")``
against the JAX package over the same 3 progressive frames.

- glass_spheres + env map vs JAX ``render_accumulate_pallas`` (interpret
  mode, the TPU main path) chained over 3 frames: robust statistics;
- cornell_box without env vs the JAX XLA oracle ``render_frame`` +
  ``accumulate_frame``: strict (rtol 1e-4, atol 1e-5);
- ``image_u8`` vs JAX ``postprocess_image``: u8 values within 1.
"""

import re

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_robust, jax_cfg, port_cfg, port_scene
from cpuperformanceraytracer_tpu.kernels.megakernel import (
    render_accumulate_pallas,
)
from cpuperformanceraytracer_tpu.render import frame as jframe
from cpuperformanceraytracer_tpu.scene.presets import (
    cornell_box_scene,
    glass_spheres_scene,
)
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.app import cli
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.io.convert import texture_from
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    pack_tables,
    render_planes,
)
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer

FRAMES = 3


def _port_run(jscene, jcam, jtex, jcfg, warmup):
    scene, cam = port_scene(jscene, jcam)
    cfg = port_cfg(jcfg, num_frames=FRAMES, warmup_frames=warmup)
    tex = None if jtex is None else texture_from(jtex)
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam)
    timer = r.run()
    assert timer.timed_frames == FRAMES and r.frame == FRAMES
    return r


def _stack(v3):
    return np.stack([np.asarray(c) for c in v3])


@pytest.fixture(scope="module")
def glass():
    jscene, jcam = glass_spheres_scene()
    jtex = texture_from_array(gradient_sky(64, 32))
    jcfg = jax_cfg(scene="glass_spheres", bounces=3, jitter=True,
                   env_mode="equirect", env_sampling="stochastic")
    accum = jframe.zero_accum(jcfg)
    for f in range(FRAMES):
        accum = render_accumulate_pallas(jscene, jcam, jtex, jcfg, f, accum)
    return _port_run(jscene, jcam, jtex, jcfg, warmup=1), jcfg, accum


@pytest.fixture(scope="module")
def cornell():
    jscene, jcam = cornell_box_scene()
    jcfg = jax_cfg(scene="cornell_box", bounces=2, env_mode="none",
                   ambient=(0.1, 0.1, 0.1), env_flip_xz=False, jitter=True,
                   roulette="v4_quirk", backend="xla")
    accum = jframe.zero_accum(jcfg)
    for f in range(FRAMES):
        color = jframe.render_frame(jscene, jcam, None, jcfg, f)
        accum = jframe.accumulate_frame(accum, color, f)
    return _port_run(jscene, jcam, None, jcfg, warmup=0), jcfg, accum


def test_glass_env_accumulation_robust(glass):
    r, _, accum = glass
    got, want = r.accum.numpy(), _stack(accum)
    assert np.isfinite(got).all() and got.mean() > 0.0
    for c in range(3):
        assert_robust(got[c], want[c], what=f"channel {c}")


def test_cornell_accumulation_strict(cornell):
    r, _, accum = cornell
    np.testing.assert_allclose(r.accum.numpy(), _stack(accum), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["glass", "cornell"])
def test_image_u8_within_one(case, request):
    """The port's display transform vs JAX ``postprocess_image`` on the
    same accumulation."""
    import jax.numpy as jnp
    from cpuperformanceraytracer_tpu.core.vecmath import Vec3

    r, jcfg, _ = request.getfixturevalue(case)
    got = r.image_u8()
    want = np.asarray(jframe.postprocess_image(
        Vec3(*(jnp.asarray(c) for c in r.accum.numpy())), jcfg.exposure,
        jcfg))
    assert got.shape == want.shape == (jcfg.height, jcfg.width, 3)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_torch_backend_launches_no_kernel(glass):
    """backend="torch" runs the plain versions; no CUDA launch counted."""
    r, _, _ = glass
    a, b = render_planes.launches, env_accumulate.launches
    r.step()
    assert (render_planes.launches, env_accumulate.launches) == (a, b)


def test_cuda_backend_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: nothing to refuse")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        OfflineRenderer(RenderConfig(width=32, height=8, env_mode="none",
                                     backend="cuda"))


def test_env_without_texture_and_wang_multisample_env_raise():
    with pytest.raises(ValueError, match="needs a texture"):
        OfflineRenderer(RenderConfig(width=32, height=8, backend="torch"))
    tex = texture_from(texture_from_array(gradient_sky(16, 8)))
    with pytest.raises(NotImplementedError, match="counter"):
        OfflineRenderer(RenderConfig(width=32, height=8, spp=2,
                                     backend="torch"), texture=tex)


def test_counter_multisample_env_frame():
    """spp > 1 with an env map: one kernel-A launch per sample, summed by
    kernel B, divided once; equals the mean of single-sample frames."""
    tex = texture_from(texture_from_array(gradient_sky(16, 8)))
    kw = dict(width=32, height=8, bounces=2, rng="counter", num_frames=1,
              warmup_frames=0, backend="torch")
    r = OfflineRenderer(RenderConfig(spp=3, **kw), texture=tex)
    r.step()
    one = RenderConfig(spp=1, **kw)
    tables = pack_tables(r.scene, r.camera, one, "cpu")
    total = torch.zeros_like(r.accum)
    for s in range(3):
        env_accumulate(render_planes(tables, one, 0, sample0=s), r.texture,
                       one, total, sum_into=True)
    torch.testing.assert_close(r.accum, total * np.float32(1.0 / 3.0),
                               rtol=0, atol=0)


def test_cli_render(tmp_path, capsys):
    out = tmp_path / "img.png"
    rc = cli.main(["render", "--scene", "cornell_box", "--env", "none",
                   "--width", "32", "--height", "16", "--frames", "2",
                   "--bounces", "1", "--backend", "torch", "-o", str(out)])
    assert rc == 0 and out.stat().st_size > 0
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"[\d.]+ ms/frame; [\d.]+ Mrays/s; wrote .+", line)
    assert cli.main(["render", "--scene", "nope", "-o", str(out)]) == 2


def test_write_image_and_screenshot(cornell, tmp_path):
    """BMP and PNG bytes equal the JAX package's writers' on one image."""
    from cpuperformanceraytracer_tpu.io import image as jimage
    from cpuperformanceraytracer_tpu_torch.io.image import read_bmp

    r, _, _ = cornell
    img = r.image_u8()
    for ext, writer in (("bmp", jimage.write_bmp), ("png", jimage.write_png)):
        ours, theirs = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        r.write_image(str(ours))
        writer(str(theirs), img)
        assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(read_bmp(str(tmp_path / "a.bmp")), img)
    shot = r.screenshot(str(tmp_path))
    assert shot.endswith(f"_frame{r.frame}.bmp")
    np.testing.assert_array_equal(read_bmp(shot), img)


def test_frame_timer_matches_jax():
    from cpuperformanceraytracer_tpu.utils.timing import FrameTimer as J
    from cpuperformanceraytracer_tpu_torch.utils.timing import FrameTimer as T

    t, j = T(warmup_frames=3), J(warmup_frames=3)
    for sec, n in ((0.5, 2), (0.4, 4), (1.0, 10)):
        t.add_span(sec, n)
        j.add_span(sec, n)
    assert t.spans == j.spans and t.timed_frames == j.timed_frames == 13
    assert t.mean_ms == pytest.approx(j.mean_ms)
    assert t.rays_per_second(100) == pytest.approx(j.rays_per_second(100))
