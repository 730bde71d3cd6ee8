"""The slices end to end: the port's ``OfflineRenderer(backend="torch")``
against the JAX package over the same progressive frames.

- glass_spheres + env map vs JAX ``render_accumulate_pallas`` (interpret
  mode, the TPU main path) chained over 3 frames: robust statistics;
- cornell_box without env vs the JAX XLA oracle ``render_frame`` +
  ``accumulate_frame``: strict (rtol 1e-4, atol 1e-5);
- ``image_u8`` vs JAX ``postprocess_image``: u8 values within 1;
- the textured multi-sample frame (spp 2, counter RNG, 1 bounce; the A
  -> E -> F route) for bilinear equirect, cubemap nearest and stochastic
  equirect,
  frame by frame over 2 frames: on cornell_box strict (rtol 1e-4) vs
  JAX ``accumulate_frame(render_frame_pallas(...))`` and, for bilinear
  and cubemap, vs the XLA oracle; on glass_spheres (bilinear) robust;
- the JAX fused step's bilinear at spp > 1 (``make_frame_fn`` ->
  ``render_accumulate_pallas``) takes the nearest tap; the port does not;
- the ``watch`` and ``bench`` commands and ``render --cubemap``.
"""

import functools
import io
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_robust, jax_cfg, port_cfg, port_scene
from cpuperformanceraytracer_tpu.kernels.megakernel import (
    render_accumulate_pallas,
    render_frame_pallas,
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
from cpuperformanceraytracer_tpu_torch.kernels.combine import combine_accumulate
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import env_accumulate
from cpuperformanceraytracer_tpu_torch.kernels.env_gather import env_lookup
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
    # one trace of the interpret-mode kernel serves every frame
    step = jax.jit(lambda f, a: render_accumulate_pallas(jscene, jcam, jtex,
                                                         jcfg, f, a))
    accum = jframe.zero_accum(jcfg)
    for f in range(FRAMES):
        accum = step(jnp.int32(f), accum)
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
    """spp > 1 with an env map: one kernel-A launch per sample into one
    (spp, 12, H, W) buffer, kernel E per sample, kernel F once: equals
    that composition of the wrappers."""
    tex = texture_from(texture_from_array(gradient_sky(16, 8)))
    kw = dict(width=32, height=8, bounces=2, rng="counter", num_frames=1,
              warmup_frames=0, backend="torch")
    r = OfflineRenderer(RenderConfig(spp=3, **kw), texture=tex)
    r.step()
    one = RenderConfig(spp=1, **kw)
    tables = pack_tables(r.scene, r.camera, one, "cpu")
    planes = torch.stack([render_planes(tables, one, 0, sample0=s)
                          for s in range(3)])
    e4 = torch.stack([env_lookup(planes[s], r.texture, one)
                      for s in range(3)])
    want = combine_accumulate(e4, planes[:, 0:3], planes[:, 6:9],
                              torch.zeros_like(r.accum), 1.0)
    torch.testing.assert_close(r.accum, want, rtol=0, atol=0)


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


MS_FRAMES = 2
MODES = [("equirect", "bilinear"), ("cubemap", "nearest"),
         ("equirect", "stochastic")]


def _jax_texture(env_mode):
    if env_mode == "cubemap":
        return texture_from_array(np.concatenate(
            [gradient_sky(16, 16, seed=i) for i in range(6)]))
    return texture_from_array(gradient_sky(64, 32))


def _ms_cfg(scene, env_mode, sampling, bounces):
    # one bounce: each segment of the interpret-mode kernel adds ~5 s of
    # trace and compile per sample to the JAX reference
    return jax_cfg(scene=scene, bounces=bounces, spp=2, rng="counter",
                   env_mode=env_mode, env_sampling=sampling)


@functools.lru_cache(maxsize=None)
def _jax_multisample(scene, env_mode, sampling, oracle=False, bounces=1):
    """JAX accumulators after each of MS_FRAMES frames: ``accumulate_frame``
    of ``render_frame_pallas`` (interpret mode), or of the XLA oracle
    ``render_frame``; one jit trace serves every frame."""
    jscene, jcam = (cornell_box_scene() if scene == "cornell_box"
                    else glass_spheres_scene())
    jtex = _jax_texture(env_mode)
    jcfg = _ms_cfg(scene, env_mode, sampling, bounces)
    render = jframe.render_frame if oracle else render_frame_pallas
    frame_fn = jax.jit(lambda f: render(jscene, jcam, jtex, jcfg, f))
    accum, out = jframe.zero_accum(jcfg), []
    for f in range(MS_FRAMES):
        accum = jframe.accumulate_frame(accum, frame_fn(jnp.int32(f)), f)
        out.append(_stack(accum))
    return out


def _port_multisample(scene, env_mode, sampling, bounces=1):
    """The port's plain path, accumulators after each frame."""
    jscene, jcam = (cornell_box_scene() if scene == "cornell_box"
                    else glass_spheres_scene())
    tscene, tcam = port_scene(jscene, jcam)
    cfg = port_cfg(_ms_cfg(scene, env_mode, sampling, bounces),
                   warmup_frames=0)
    r = OfflineRenderer(cfg, texture=texture_from(_jax_texture(env_mode)),
                        scene=tscene, camera=tcam, silent=True)
    out = []
    for _ in range(MS_FRAMES):
        r.step()
        out.append(r.accum.numpy().copy())
    return out


@pytest.mark.parametrize("env_mode,sampling", MODES)
def test_multisample_env_cornell_strict(env_mode, sampling):
    got = _port_multisample("cornell_box", env_mode, sampling)
    refs = {"render_frame_pallas": _jax_multisample("cornell_box", env_mode,
                                                    sampling)}
    if sampling != "stochastic":   # the lookups new to the port
        refs["the XLA oracle"] = _jax_multisample("cornell_box", env_mode,
                                                  sampling, oracle=True)
    for f in range(MS_FRAMES):
        assert got[f].mean() > 0.0
        for name, want in refs.items():
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5,
                                       err_msg=f"vs {name}, frame {f}")


def test_multisample_bilinear_glass_robust():
    got = _port_multisample("glass_spheres", "equirect", "bilinear")
    want = _jax_multisample("glass_spheres", "equirect", "bilinear")
    for f in range(MS_FRAMES):
        for c in range(3):
            assert_robust(got[f][c], want[f][c], what=f"frame {f} ch {c}")


def test_jax_fused_bilinear_takes_nearest_port_does_not():
    """JAX's production step for spp > 1 (``render_accumulate_pallas``)
    looks bilinear up through ``env_texel_flat_index``, whose nearest
    branch it silently takes. The port's bilinear frame equals JAX's
    per-sample bilinear (``render_frame_pallas``, the test above), not
    the fused step. No bounce (the env lookup is the point) keeps the
    interpret-mode trace short."""
    jscene, jcam = cornell_box_scene()
    jtex = _jax_texture("equirect")
    jcfg = _ms_cfg("cornell_box", "equirect", "bilinear", 0)
    step = jframe.make_frame_fn(jcfg, scene=jscene, camera=jcam)
    fused = _stack(step(jscene, jcam, jtex, 0, jframe.zero_accum(jcfg)))
    bilinear, nearest = (
        _port_multisample("cornell_box", "equirect", s, bounces=0)[0]
        for s in ("bilinear", "nearest"))
    np.testing.assert_allclose(fused, nearest, rtol=1e-4, atol=1e-5)
    assert np.abs(bilinear - nearest).max() > 1e-3
    assert np.abs(fused - bilinear).max() > 1e-3


_TINY = ["--scene", "cornell_box", "--width", "32", "--height", "8",
         "--bounces", "1", "--backend", "torch", "--warmup", "1"]


def test_cli_watch_rewrites_the_image(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))   # not a tty
    out = tmp_path / "w.png"
    assert cli.main(["watch", *_TINY, "--env", "none", "--frames", "5",
                     "--interval", "2", "-o", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" | ")[0] for ln in lines] == [
        "frame 2/5", "frame 4/5", "frame 5/5"]
    assert all(re.search(r"[\d.]+ ms/frame .*w\.png$", ln) for ln in lines)
    assert out.read_bytes().startswith(b"\x89PNG")
    assert cli.main(["watch", *_TINY, "--env", "procedural", "--frames",
                     "2", "--interval", "2", "--live", "-o", str(out)]) == 0
    live = capsys.readouterr().out
    assert "\x1b[38;2;" in live and "frame 2/2" in live


def test_cli_bench_one_json_line_per_config(capsys, monkeypatch):
    tiny = {k: cli.BENCH_CONFIGS[k].replace(width=32, height=8, spp=2,
                                             bounces=1)
            for k in ("scalar_320", "textured_1080")}
    monkeypatch.setattr(cli, "BENCH_CONFIGS", tiny)
    monkeypatch.setattr(cli, "BENCH_SKY", {"textured_1080": (32, 16)})
    assert cli.main(["bench", "scalar_320", "textured_1080", "--backend",
                     "torch", "--frames", "2"]) == 0
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["config"] for r in rows] == ["scalar_320", "textured_1080"]
    assert rows[0]["env_texture"] is None
    assert rows[1]["env_texture"] == "procedural_32x16"
    assert all(r["ms_per_frame"] > 0 and r["frames"] == 2
               and r["device"] == "cpu" for r in rows)
    assert rows[1]["size"] == "32x8 spp2 b1"
    assert cli.main(["bench", "nope", "--backend", "torch"]) == 2


def test_cli_render_cubemap_checkpoint(tmp_path, capsys):
    from cpuperformanceraytracer_tpu_torch.texture.hdr import write_hdr

    faces = []
    for i in range(6):
        faces.append(str(tmp_path / f"f{i}.hdr"))
        write_hdr(faces[-1], gradient_sky(16, 16, seed=i))
    ck, out = tmp_path / "ck.npz", tmp_path / "c.bmp"
    args = ["render", *_TINY, "--cubemap", *faces, "--env-sampling",
            "bilinear", "--spp", "2", "--rng", "counter", "--frames", "2",
            "--checkpoint", str(ck), "--checkpoint-every", "2",
            "-o", str(out), "--silent"]
    assert cli.main(args) == 0 and out.stat().st_size > 0
    assert cli.main(args) == 0            # resumes at frame 2, saves at 4
    with np.load(ck) as z:
        assert int(z["frame"]) == 4
        assert json.loads(str(z["config"]))["env_mode"] == "cubemap"
    capsys.readouterr()
    assert cli.main(["render", *_TINY, "--env", "procedural", "--spp", "2",
                     "-o", str(out)]) == 2
    assert "counter" in capsys.readouterr().err
