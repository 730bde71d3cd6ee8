"""The port's public surface against the JAX package's.

- Every name a JAX subpackage's ``__init__.py`` imports is importable
  from the port's subpackage of the same name, or renamed in ``RENAMED``
  (the table in README.md), whose targets exist.
- The RNG-threaded env samplers on the same inputs (numpy seed 0):
  ``sample_stochastic`` gives bit-equal colours and RNG state after, for
  both RNGs; ``sample_environment`` takes 2 draws iff it is stochastic
  with a texture, as JAX's; equirect and cubemap colours are bit-equal
  wherever the texel index matches, which it must on >= 99% of
  directions (XLA's and torch's atan2/asin differ by an ulp); bilinear is
  held at rtol 1e-3 (that ulp, times the texel step, moves a weight).
- ``segment_sum_sorted`` against JAX's at rtol 1e-5, with an atol of
  2^-22 of the sum of |values| (JAX's f32 prefix sums round at the size
  of the running total, not of each segment: a few ulps of the total),
  and within 1e-6 relative of a float64 sum (the port sums each run in
  float64); the same bits on two calls.
- The core helpers bit-equal to JAX's, ``length`` within an ulp (torch's
  CPU sqrt is an ulp off on some inputs).
- ``RenderState`` after a resume from one checkpoint equals JAX's;
  ``accum_to_vec3`` equals JAX's.
- No port module imports jax or the JAX package, and importing them all
  builds no CUDA library (a subprocess with both blocked).
"""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpuperformanceraytracer_tpu as jax_pkg
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.core import rng as jrng
from cpuperformanceraytracer_tpu.core import vecmath as jvm
from cpuperformanceraytracer_tpu.diff.segsum import segment_sum_sorted as jax_segsum
from cpuperformanceraytracer_tpu.render import frame as jframe
from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer as JaxRenderer
from cpuperformanceraytracer_tpu.texture import texture as jtx
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from torch_port_helpers import port_cfg
from cpuperformanceraytracer_tpu_torch.core import rng as prng
from cpuperformanceraytracer_tpu_torch.core import vecmath as pvm
from cpuperformanceraytracer_tpu_torch.diff.segsum import segment_sum_sorted
from cpuperformanceraytracer_tpu_torch.io.checkpoint import save_checkpoint
from cpuperformanceraytracer_tpu_torch.render import frame as pframe
from cpuperformanceraytracer_tpu_torch.render.driver import (
    OfflineRenderer,
    RenderState,
)
from cpuperformanceraytracer_tpu_torch.texture import texture as ptx

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("core", "scene", "texture", "render", "diff", "io", "utils",
               "kernels", "parallel")
# JAX name -> the port's name, where they differ
RENAMED = {"kernels": {"render_frame_pallas": "render_planes",
                       "postprocess_pallas": "tonemap"}}
N = 4096


def _exported(sub):
    path = Path(jax_pkg.__file__).parent / sub / "__init__.py"
    tree = ast.parse(path.read_text())
    return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_name_is_exported(sub):
    port = importlib.import_module(f"cpuperformanceraytracer_tpu_torch.{sub}")
    names = _exported(sub)
    assert names
    renamed = RENAMED.get(sub, {})
    missing = [n for n in names if not hasattr(port, renamed.get(n, n))]
    assert not missing, f"{sub}: {missing}"


# ---- the samplers -----------------------------------------------------------

def _textures():
    """(JAX, port) equirect 32x16 and cubemap (six 8x8 faces) textures."""
    out = {}
    for mode, rgb in (("equirect", gradient_sky(32, 16)),
                      ("cubemap", np.concatenate(
                          [gradient_sky(8, 8, seed=i) for i in range(6)]))):
        out[mode] = (jtx.texture_from_array(rgb), ptx.texture_from_array(rgb))
    return out


TEX = _textures()


def _directions(seed=0):
    d = np.random.RandomState(seed).normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return d


def _rngs(kind, seed=1):
    """(JAX, port) RNGs of N pixels."""
    rs = np.random.RandomState(seed)
    x, y, f, s = (rs.randint(0, 4096, N).astype(np.uint32) for _ in range(4))
    if kind == "wang":
        return (jrng.WangRng.from_pixel(x, y, f),
                prng.WangRng.from_pixel(*(torch.from_numpy(a.astype(np.int64))
                                          for a in (x, y, f))))
    return (jrng.CounterRng.from_pixel(x, y, f, s),
            prng.CounterRng.from_pixel(*(torch.from_numpy(a.astype(np.int64))
                                         for a in (x, y, f, s))))


def _same_state(jr, pr):
    """The two RNGs' states are bit-equal."""
    for a, b in zip(jr, pr):
        a = np.asarray(a).astype(np.int64)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.int64(b)
        if not np.array_equal(np.broadcast_to(a, np.shape(b)), b):
            return False
    return True


def _np(v):
    return np.stack([np.asarray(c) for c in v])


def _pt(v):
    return np.stack([c.numpy() for c in v])


@pytest.mark.parametrize("kind", ["wang", "counter"])
def test_sample_stochastic_bit_equal(kind):
    rs = np.random.RandomState(2)
    u, v = rs.rand(2, N).astype(np.float32)
    u[:4], v[:4] = [0.0, 1.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0]
    jtex, tex = TEX["equirect"]
    jr, pr = _rngs(kind)
    jc, jr = jtx.sample_stochastic(jtex, jvm.Vec2(jnp.asarray(u),
                                                  jnp.asarray(v)), jr)
    pc, pr = ptx.sample_stochastic(tex, torch.from_numpy(u),
                                   torch.from_numpy(v), pr)
    np.testing.assert_array_equal(_pt(pc), _np(jc))
    assert _same_state(jr, pr)


def _advanced(draws):
    """The port wang RNG of ``_rngs`` after ``draws`` draws."""
    r = _rngs("wang")[1]
    for _ in range(draws):
        _, r = r.next01()
    return r


@pytest.mark.parametrize("env_mode", ["none", "equirect", "cubemap"])
@pytest.mark.parametrize("sampling", ["stochastic", "bilinear", "nearest"])
@pytest.mark.parametrize("has_tex", [True, False])
def test_sample_environment_draws(env_mode, sampling, has_tex):
    """2 draws iff stochastic with a texture (and an env mode that has
    one), in both packages."""
    jcfg = JaxConfig(env_mode=env_mode, env_sampling=sampling)
    cfg = port_cfg(jcfg)
    jtex, tex = (TEX.get(env_mode, TEX["equirect"]) if has_tex
                 else (None, None))
    d = _directions()
    jr, pr = _rngs("wang")
    _, jr = jtx.sample_environment(jtex, jvm.Vec3(*map(jnp.asarray, d)),
                                   jcfg, jr)
    _, pr = ptx.sample_environment(tex, pvm.Vec3(*map(torch.from_numpy, d)),
                                   cfg, pr)
    draws = 2 if (env_mode != "none" and has_tex
                  and sampling == "stochastic") else 0
    assert torch.equal(pr.state, _advanced(draws).state)
    assert _same_state(jr, pr)


@pytest.mark.parametrize("env_mode,flip", [("equirect", True),
                                           ("equirect", False),
                                           ("cubemap", True)])
@pytest.mark.parametrize("sampling", ["stochastic", "nearest", "bilinear"])
def test_sample_environment_colours(env_mode, flip, sampling):
    jcfg = JaxConfig(env_mode=env_mode, env_sampling=sampling,
                     env_flip_xz=flip)
    cfg = port_cfg(jcfg)
    jtex, tex = TEX[env_mode]
    d = _directions()
    jd, pd = jvm.Vec3(*map(jnp.asarray, d)), pvm.Vec3(*map(torch.from_numpy, d))
    jr, pr = _rngs("counter")
    jc, _ = jtx.sample_environment(jtex, jd, jcfg, jr)
    pc, _ = ptx.sample_environment(tex, pd, cfg, pr)
    got, want = _pt(pc), _np(jc)
    if sampling == "bilinear":
        np.testing.assert_allclose(got, want, rtol=1e-3)
        return
    # the jitter the stochastic lookup drew, for the texel index
    jitter = [None, None]
    r = _rngs("counter")[1]
    for i in range(2):
        jitter[i], r = r.next01()
    n_tex = tex.width * tex.height
    idx = np.clip(ptx.env_texel_flat_index(tex, pd, cfg, *jitter).numpy(),
                  0, n_tex - 1)
    jidx = np.clip(np.asarray(jtx.env_texel_flat_index(
        jtex, jd, jcfg, *(jnp.asarray(j.numpy()) for j in jitter))),
        0, n_tex - 1)
    same = idx == jidx
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(got[:, same], want[:, same])
    np.testing.assert_array_equal(_pt(ptx.gather_texels(
        tex, torch.from_numpy(idx))), got)


@pytest.mark.parametrize("mode", ["stochastic", "bilinear", "nearest"])
def test_sample_equirect_and_cubemap_take_no_flip(mode):
    """The two direct samplers look the direction up as it is (the
    flip is ``sample_environment``'s), as JAX's."""
    d = _directions(3)
    jd, pd = jvm.Vec3(*map(jnp.asarray, d)), pvm.Vec3(*map(torch.from_numpy, d))
    for env_mode, jfn, pfn in (("equirect", jtx.sample_equirect,
                                ptx.sample_equirect),
                               ("cubemap", jtx.sample_cubemap,
                                ptx.sample_cubemap)):
        jtex, tex = TEX[env_mode]
        jr, pr = _rngs("wang")
        jc, jr = jfn(jtex, jd, mode, jr)
        pc, pr = pfn(tex, pd, mode, pr)
        assert _same_state(jr, pr)
        cfg = port_cfg(JaxConfig(env_mode=env_mode, env_sampling=mode,
                                 env_flip_xz=False))
        pe, _ = ptx.sample_environment(tex, pd, cfg, _rngs("wang")[1])
        np.testing.assert_array_equal(_pt(pc), _pt(pe))
        if mode == "bilinear":
            np.testing.assert_allclose(_pt(pc), _np(jc), rtol=1e-3)
        else:
            assert np.mean(np.all(_pt(pc) == _np(jc), axis=0)) >= 0.99


# ---- segment_sum_sorted -----------------------------------------------------

def _segsum_cases():
    rs = np.random.RandomState(4)
    used = rs.choice(64, 40, replace=False)  # 24 empty segments
    return {
        "random": (used[rs.randint(0, 40, 3000)], 64, rs.randn(3, 3000)),
        "empty": (np.zeros(0, np.int64), 10, np.zeros((3, 0))),
        "one_index": (np.full(500, 7), 9, rs.rand(3, 500)),
        "positive": (rs.randint(0, 1000, 20000), 1000, rs.rand(3, 20000)),
    }


@pytest.mark.parametrize("case", ["random", "empty", "one_index", "positive"])
def test_segment_sum_sorted_matches_jax(case):
    idx, t, vals = _segsum_cases()[case]
    vals = vals.astype(np.float32)
    want = jax_segsum(jnp.asarray(idx, jnp.int32),
                      [jnp.asarray(v) for v in vals], t)
    pidx = torch.from_numpy(idx.astype(np.int64))
    got = segment_sum_sorted(pidx, [torch.from_numpy(v) for v in vals], t)
    again = segment_sum_sorted(pidx, [torch.from_numpy(v) for v in vals], t)
    assert len(got) == 3
    for c in range(3):
        a, w = got[c].numpy(), np.asarray(want[c])
        assert a.shape == (t,) and a.dtype == np.float32
        assert torch.equal(got[c], again[c])
        exact = np.bincount(idx, weights=vals[c].astype(np.float64),
                            minlength=t)
        total = np.abs(vals[c]).astype(np.float64).sum()
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=2 ** -22 * total)
        np.testing.assert_allclose(a, exact, rtol=1e-6,
                                   atol=1e-6 * np.abs(exact).max(initial=0.0))
        if case == "random":
            empty = np.setdiff1d(np.arange(t), idx)
            assert empty.size and not a[empty].any()


# ---- core helpers -----------------------------------------------------------

def test_core_helpers_bit_equal():
    rs = np.random.RandomState(5)
    a, b, c, d, e, f, t = (rs.uniform(-2, 2, 257).astype(np.float32)
                           for _ in range(7))
    J = lambda *xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    T = lambda *xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    jv2, jw2 = jvm.vec2(*J(a, b)), jvm.vec2(*J(c, d))
    pv2, pw2 = pvm.vec2(*T(a, b)), pvm.vec2(*T(c, d))
    j3, k3 = jvm.vec3(*J(a, b, c)), jvm.vec3(*J(d, e, f))
    p3, q3 = pvm.vec3(*T(a, b, c)), pvm.vec3(*T(d, e, f))
    jt, pt = J(t)[0], T(t)[0]
    pairs = [
        (jvm.dot2(jv2, jw2), pvm.dot2(pv2, pw2)),
        (jv2 + jw2, pv2 + pw2), (jv2 - 0.5, pv2 - 0.5), (jv2 * jw2, pv2 * pw2),
        (2.0 * jv2, 2.0 * pv2),
        (jvm.lerp(*J(a, b), jt), pvm.lerp(*T(a, b), pt)),
        (jvm.lerp3(j3, k3, jt), pvm.lerp3(p3, q3, pt)),
        (jvm.saturate(J(a)[0]), pvm.saturate(T(a)[0])),
        (jvm.saturate3(j3), pvm.saturate3(p3)),
        (jvm.from_array(jnp.stack(J(a, b, c), -1)),
         pvm.from_array(torch.stack(T(a, b, c), -1))),
        (jvm.vec3(0.25), pvm.vec3(0.25)), (jvm.vec2(1, 2), pvm.vec2(1, 2)),
        (jrng.signed_rand01(jnp.asarray(a.view(np.uint32))),
         prng.signed_rand01(torch.from_numpy(a.view(np.uint32).astype(np.int64)))),
    ]
    for i, (want, got) in enumerate(pairs):
        want = np.asarray(want if not isinstance(want, tuple) else _np(want))
        got = (got.numpy() if isinstance(got, torch.Tensor)
               else np.stack([g.numpy() for g in got]))
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=f"pair {i}")
    np.testing.assert_allclose(pvm.length(p3).numpy(),
                               np.asarray(jvm.length(j3)), rtol=2 ** -23)


# ---- RenderState, accum_to_vec3 ---------------------------------------------

def test_render_state_after_resume_as_jax(tmp_path):
    jcfg = JaxConfig(width=16, height=8, bounces=2, scene="cornell_box",
                     env_mode="none", backend="xla")
    cfg = port_cfg(jcfg)
    r = OfflineRenderer(cfg, silent=True)
    r.step_k(3)
    steps = OfflineRenderer(cfg, silent=True)
    for _ in range(3):
        steps.step()
    assert r.state.frame == steps.state.frame == 3
    assert torch.equal(r.state.accum, steps.state.accum)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, r.accum, r.frame, cfg)

    jr = JaxRenderer(jcfg, silent=True)
    jr.resume(path)
    fresh = OfflineRenderer(cfg, silent=True)
    fresh.resume(path)
    assert isinstance(fresh.state, RenderState)
    assert fresh.state.frame == jr.state.frame == 3
    np.testing.assert_array_equal(fresh.state.accum.numpy(),
                                  _np(jr.state.accum))
    fresh.state = RenderState(torch.zeros_like(fresh.accum), 7)
    assert fresh.frame == 7 and not fresh.accum.any()


def test_accum_to_vec3_as_jax():
    rs = np.random.RandomState(6)
    accum = rs.rand(3, 4, 5).astype(np.float32)
    want = jframe.accum_to_vec3(jvm.Vec3(*map(jnp.asarray, accum)))
    np.testing.assert_array_equal(
        _pt(pframe.accum_to_vec3(torch.from_numpy(accum))), _np(want))
    flat = accum.reshape(3, -1)
    jcfg = JaxConfig(width=5, height=4)
    want = jframe.accum_to_vec3(jvm.Vec3(*map(jnp.asarray, flat)), jcfg)
    np.testing.assert_array_equal(
        _pt(pframe.accum_to_vec3(pvm.Vec3(*map(torch.from_numpy, flat)),
                                 port_cfg(jcfg))), _np(want))


# ---- no jax in the port -----------------------------------------------------

_NO_JAX = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "cpuperformanceraytracer_tpu"):
    sys.modules[name] = None
import cpuperformanceraytracer_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from cpuperformanceraytracer_tpu_torch.kernels import _build
assert _build.load_library.cache_info().currsize == 0, "a library was built"
print("\\n".join(names))
"""


def test_no_port_module_imports_jax():
    """Every port module (``scripts/`` and ``bench`` included) and
    ``chip_smoke.py`` import with jax and the JAX package blocked, and
    importing them builds no CUDA library."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(out.stdout.split())
    for name in ("bench", "scripts.run_offline_4k", "scripts.inverse_env_demo",
                 "diff.segsum", "render.driver", "kernels.megakernel"):
        assert f"cpuperformanceraytracer_tpu_torch.{name}" in names, name
