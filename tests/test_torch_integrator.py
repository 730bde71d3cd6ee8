"""The port's oracle integrator (``render/integrator.py``,
``backend="oracle"``) against the JAX package's ``render_frame`` (its
``backend="xla"`` route) on the same inputs, at 128x32 and 2 bounces.

- strict cases: the diffuse cornell box under the wang and the counter
  RNG, and the wang RNG with spp 2 and an env map (the config the kernel
  routes refuse), and the three env samplings x equirect/cubemap on the
  cornell box: rtol 1e-5 and atol 1e-6, ulp level. The two sides agree
  bit for bit on these inputs; the tolerance leaves room for XLA's
  fused multiply-adds on the CPU and torch's CPU sqrt, which is an ulp
  off on some inputs. Bilinear takes rtol 1e-3: XLA's and torch's
  atan2/asin differ by an ulp on about a third of directions, and the
  lerp weight carries that ulp times (size - 1) times the step between
  two texels (up to 3.35 in this sky), where a nearest or jittered tap
  changes only when it crosses a texel edge;
- glass_spheres with an env map: robust statistics (a 1-ulp difference
  may flip a lottery path);
- the intersection cases of ``tests/test_integrator.py::TestIntersection``
  through both packages' ``trace_scene``;
- the oracle against the port's plain kernel-A route (``backend="torch"``)
  on the cornell box: the two formulate the sphere normal differently
  (``safe_normalize(hit_rel)`` against ``hit_rel * (1/r)``), so rtol
  1e-4 and atol 1e-5;
- the oracle route through ``make_frame_fn``, ``OfflineRenderer`` and
  ``render --backend oracle``.

Each JAX render is traced once (``functools.lru_cache``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_robust, port_cfg, port_scene
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.core.vecmath import normalize, vec3
from cpuperformanceraytracer_tpu.render import frame as jframe
from cpuperformanceraytracer_tpu.render import integrator as jint
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu.scene.types import Material, precompute_quads
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.app import cli
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.io.convert import texture_from
from cpuperformanceraytracer_tpu_torch.render import integrator as tint
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.render.frame import frame_blend
from cpuperformanceraytracer_tpu_torch.scene.types import (
    precompute_quads as t_precompute_quads,
)

FRAME = 3
BASE = dict(width=128, height=32, bounces=2, spp=1, num_frames=2,
            warmup_frames=0, backend="xla")
CASES = {
    "cornell_wang": dict(scene="cornell_box", env_mode="none", rng="wang"),
    "cornell_counter": dict(scene="cornell_box", env_mode="none",
                            rng="counter", roulette="terminate"),
    "cornell_wang_spp2_env": dict(scene="cornell_box", env_mode="equirect",
                                  rng="wang", spp=2),
    "glass_env": dict(scene="glass_spheres", env_mode="equirect",
                      rng="wang"),
}


def _texture(env_mode):
    if env_mode == "none":
        return None
    if env_mode == "cubemap":
        return texture_from_array(np.concatenate(
            [gradient_sky(16, 16, seed=i) for i in range(6)]))
    return texture_from_array(gradient_sky(64, 32))


def _key(kw):
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _render_both(key):
    """(JAX ``render_frame``, the port's oracle ``render_frame``) of one
    config at frame FRAME, as numpy (3, H, W)."""
    jcfg = JaxConfig(**{**BASE, **dict(key)})
    jscene, jcam = scene_by_name(jcfg.scene)
    jtex = _texture(jcfg.env_mode)
    want = jax.jit(lambda f: jframe.render_frame(jscene, jcam, jtex, jcfg,
                                                 f))(jnp.int32(FRAME))
    want = np.stack([np.asarray(c) for c in want])
    scene, cam = port_scene(jscene, jcam)
    got = tint.render_frame(scene, cam, None if jtex is None
                            else texture_from(jtex),
                            port_cfg(jcfg, backend="oracle"), FRAME)
    return got.numpy(), want


@pytest.mark.parametrize("case", ["cornell_wang", "cornell_counter",
                                  "cornell_wang_spp2_env"])
def test_diffuse_strict(case):
    got, want = _render_both(_key(CASES[case]))
    assert want.mean() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_glass_env_robust():
    got, want = _render_both(_key(CASES["glass_env"]))
    for c in range(3):
        assert_robust(got[c], want[c], what=f"channel {c}")


@pytest.mark.parametrize("env_mode", ["equirect", "cubemap"])
@pytest.mark.parametrize("sampling", ["stochastic", "nearest", "bilinear"])
def test_env_modes_strict(env_mode, sampling):
    """Every env sampling of both layouts: the deferred lookup of the
    first miss, on the cornell box (the counter RNG)."""
    kw = dict(scene="cornell_box", env_mode=env_mode, env_sampling=sampling,
              rng="counter")
    got, want = _render_both(_key(kw))
    assert want.mean() > 0.0
    rtol = 1e-3 if sampling == "bilinear" else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


def _simple_scenes():
    """tests/test_integrator.py's scene (a quad at z=5 and a unit sphere at
    z=10, one material), and its two-material variant, in both packages."""
    b = SceneBuilder()
    m = b.add_material(Material(albedo=(1.0, 0.5, 0.25)))
    b.add_quad((-1, -1, 5), (1, -1, 5), (1, 1, 5), (-1, 1, 5), m)
    b.add_sphere((0, 0, 10), 1.0, m)
    b2 = SceneBuilder()
    m0 = b2.add_material(Material(albedo=(1, 0, 0)))
    m1 = b2.add_material(Material(albedo=(0, 1, 0)))
    b2.add_quad((-1, -1, 5), (1, -1, 5), (1, 1, 5), (-1, 1, 5), m0)
    b2.add_sphere((0, 0, 10), 1.0, m1)
    return b.build(), b2.build()


SUPER_FAR = jint.SUPER_FAR
# (name, scene index, origin, direction, dist (None: a miss), normal
# component and its sign, from_inside, material index)
RAYS = [
    ("quad_frontal", 0, (0, 0, 0), (0, 0, 1), 5.0, ("z", -1), False, None),
    ("quad_miss_outside", 0, (0, 0, 0), (0, 3, 1), None, None, None, None),
    ("quad_backside", 0, (0, 0, 7), (0, 0, -1), 2.0, ("z", 1), False, None),
    *[(f"quad_diagonal_{i}", 0, (x, y, 0), (0, 0, 1), 5.0, None, None, None)
      for i, (x, y) in enumerate([(-0.9, -0.9), (0.9, 0.9), (-0.9, 0.9),
                                  (0.9, -0.9)])],
    ("sphere_outside", 0, (0, 5, 10), (0, -1, 0), 4.0, ("y", 1), False, None),
    ("sphere_inside", 0, (0, 0, 10), (0, 1, 0), 1.0, ("y", -1), True, None),
    ("sphere_behind", 0, (0, 5, 10), (0, 1, 0), None, None, None, None),
    ("nearest_quad_wins", 0, (0, 0, 0), (0, 0, 1), 5.0, None, None, None),
    ("nearest_sphere_past_quad", 0, (0, 0, 6), (0, 0, 1), 3.0, None, None,
     None),
    ("min_hit_time", 0, (0, 0, 5), (0, 0, 1), 4.0, None, None, None),
    ("material_quad", 1, (0, 0, 0), (0, 0, 1), 5.0, None, None, 0),
    ("material_sphere", 1, (0, 0, 6), (0, 0, 1), 3.0, None, None, 1),
]


@pytest.mark.parametrize("ray", RAYS, ids=[r[0] for r in RAYS])
def test_intersection_cases(ray):
    """Each case of the JAX package's TestIntersection: the port's hit
    record equals JAX's (dist to 1e-5, the normal to 1e-6, the inside
    flag and the material exactly) and the analytic expectation."""
    _, which, pos, dir, dist, normal, inside, mat = ray
    jscene = _simple_scenes()[which]
    jhit = jint.trace_scene(jscene, precompute_quads(jscene.quads),
                            vec3(*pos), normalize(vec3(*dir)))
    scene, _ = port_scene(jscene, _simple_camera())
    d = normalize(vec3(*dir))
    ray_pos = Vec3(*(torch.tensor([float(p)]) for p in pos))
    ray_dir = Vec3(*(torch.tensor([float(np.asarray(c))]) for c in d))
    hit = tint.trace_scene(scene, t_precompute_quads(scene.quads), ray_pos,
                           ray_dir)
    np.testing.assert_allclose(hit.dist.item(), float(jhit.dist), rtol=1e-5)
    for c in "xyz":
        np.testing.assert_allclose(getattr(hit.normal, c).item(),
                                   float(getattr(jhit.normal, c)), atol=1e-6)
    assert hit.from_inside.item() == bool(jhit.from_inside)
    assert hit.material_index.item() == int(jhit.material_index)
    if dist is None:
        assert hit.dist.item() >= SUPER_FAR
    else:
        assert np.isclose(hit.dist.item(), dist, atol=1e-4)
    if normal is not None:
        assert np.sign(getattr(hit.normal, normal[0]).item()) == normal[1]
    if inside is not None:
        assert hit.from_inside.item() == inside
    if mat is not None:
        assert hit.material_index.item() == mat


def _simple_camera():
    from cpuperformanceraytracer_tpu.scene.camera import make_camera

    return make_camera()


def test_oracle_vs_plain_kernel_route():
    """The oracle and the plain kernel A + kernel B route on one config:
    the same draws, rays and decisions, the sphere normal formulated two
    ways (ulp-level differences)."""
    from cpuperformanceraytracer_tpu_torch.config import RenderConfig
    from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
        env_accumulate_reference,
    )
    from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
        pack_tables,
        render_planes_reference,
    )
    from cpuperformanceraytracer_tpu_torch.scene.presets import (
        scene_by_name as t_scene_by_name,
    )
    from cpuperformanceraytracer_tpu_torch.texture.procedural import (
        gradient_sky as t_sky,
    )
    from cpuperformanceraytracer_tpu_torch.texture.texture import (
        texture_from_array as t_texture,
    )

    cfg = RenderConfig(width=128, height=32, bounces=2, scene="cornell_box",
                       rng="counter", env_sampling="nearest",
                       backend="torch")
    scene, cam = t_scene_by_name("cornell_box")
    tex = t_texture(t_sky(64, 32))
    planes = render_planes_reference(pack_tables(scene, cam, cfg, "cpu"), cfg,
                                     FRAME)
    want = env_accumulate_reference(planes, tex, cfg,
                                    torch.zeros(3, 32, 128))
    got = tint.render_frame(scene, cam, tex, cfg.replace(backend="oracle"),
                            FRAME)
    assert want.mean() > 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_offline_renderer_oracle_accumulates_wang_spp2_env(tmp_path, capsys):
    """make_frame_fn's oracle route takes the wang RNG with spp > 1 and an
    env map (the kernel routes raise): two frames accumulate as the
    progressive mean of ``render_frame``; ``render --backend oracle``
    writes its image."""
    jcfg = JaxConfig(**{**BASE, **CASES["cornell_wang_spp2_env"]})
    jscene, jcam = scene_by_name(jcfg.scene)
    scene, cam = port_scene(jscene, jcam)
    tex = texture_from(_texture("equirect"))
    cfg = port_cfg(jcfg, backend="oracle")
    r = OfflineRenderer(cfg, texture=tex, scene=scene, camera=cam,
                        silent=True)
    r.run()
    want = torch.zeros(3, 32, 128)
    for f in range(2):
        color = tint.render_frame(scene, cam, tex, cfg, f)
        want += (color - want) * frame_blend(f)
    assert torch.equal(r.accum, want)
    out = tmp_path / "o.png"
    assert cli.main(["render", "--backend", "oracle", "--width", "32",
                     "--height", "8", "--bounces", "1", "--spp", "2",
                     "--frames", "1", "--warmup", "0", "--scene",
                     "cornell_box", "--env", "procedural", "-o", str(out),
                     "--silent"]) == 0
    assert out.exists() and "ms/frame" in capsys.readouterr().out
