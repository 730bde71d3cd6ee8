"""The port's CLI against the JAX package's: the same command line gives
the same config and the same frame.

Each command's handler is replaced by one that returns the config the
command would run, in both packages, so the parsers and the config
builders are compared field by field. ``--roulette`` reaches the
kernels: a 16x8 cornell frame of each mode on the ``torch`` backend (the
plain kernels A and B) against the frame JAX renders from its own
``_cfg_from_args`` config, strict (rtol 1e-4, atol 1e-5: the diffuse
cornell box has no lottery to flip).
"""

import numpy as np
import pytest

from cpuperformanceraytracer_tpu.app import cli as jcli
from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer as JaxRenderer
from cpuperformanceraytracer_tpu_torch.app import cli
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer

# the fields a command line sets in both packages' configs
FIELDS = ("width", "height", "spp", "bounces", "scene", "env_mode",
          "env_sampling", "rng", "roulette")
RENDER_FIELDS = FIELDS + ("num_frames", "warmup_frames", "exposure")
# the port's handler and config builder of each command, and JAX's
PORT = {"render": ("cmd_render", lambda a: cli._render_cfg(a)),
        "watch": ("cmd_watch", lambda a: cli._render_cfg(a)),
        "bench-grad": ("cmd_bench_grad", lambda a: cli._cfg(a, rng="counter")),
        "inverse": ("cmd_inverse", lambda a: cli._cfg(a, rng="counter"))}
JAX = {"render": ("cmd_render", lambda a: jcli._cfg_from_args(a)),
       "watch": ("cmd_watch", lambda a: jcli._cfg_from_args(a)),
       "bench-grad": ("cmd_bench_grad",
                      lambda a: jcli._cfg_from_args(a).replace(rng="counter")),
       "inverse": ("cmd_inverse",
                   lambda a: jcli._cfg_from_args(a).replace(rng="counter"))}


def _configs(monkeypatch, argv):
    """(JAX config, port config) of one command line."""
    got = {}
    for key, mod, table, extra in (("jax", jcli, JAX, []),
                                   ("port", cli, PORT, ["--backend", "torch"])):
        name, make = table[argv[0]]
        monkeypatch.setattr(mod, name,
                            lambda a, make=make, key=key: got.update(
                                {key: make(a)}) or 0)
        assert mod.main(argv + extra) == 0
    return got["jax"], got["port"]


@pytest.mark.parametrize("cmd", ["render", "watch", "bench-grad", "inverse"])
@pytest.mark.parametrize("mode", ["off", "terminate", "v4_quirk"])
def test_roulette_reaches_the_config(monkeypatch, cmd, mode):
    jcfg, cfg = _configs(monkeypatch, [cmd, "--roulette", mode])
    assert cfg.roulette == jcfg.roulette == mode


@pytest.mark.parametrize("cmd", ["render", "watch", "bench-grad", "inverse"])
def test_bare_command_is_jax_workload(monkeypatch, cmd):
    """No flags: ambient env (no texture), 600 frames for render and
    watch, v4_quirk roulette: every shared field as JAX's parser sets it."""
    jcfg, cfg = _configs(monkeypatch, [cmd])
    fields = RENDER_FIELDS if cmd in ("render", "watch") else FIELDS
    assert {f: getattr(cfg, f) for f in fields} == {
        f: getattr(jcfg, f) for f in fields}
    assert cfg.env_mode == "none" and cfg.roulette == "v4_quirk"
    if cmd in ("render", "watch"):
        assert cfg.num_frames == 600


def test_env_flag_as_jax(monkeypatch):
    """``--env procedural`` is JAX's equirect sky; ``--env none`` stays
    the port's spelling of the omitted flag (JAX would read a file of
    that name)."""
    jcfg, cfg = _configs(monkeypatch, ["render", "--env", "procedural"])
    assert cfg.env_mode == jcfg.env_mode == "equirect"
    _, cfg = _configs(monkeypatch, ["render", "--env", "none"])
    assert cfg.env_mode == "none"


def test_roulette_modes_render_as_jax(monkeypatch):
    """One 16x8 cornell frame of each roulette mode from the same command
    line: the port's plain kernels against JAX's frame; the modes differ."""
    means = {}
    for mode in ("off", "terminate", "v4_quirk"):
        jcfg, cfg = _configs(monkeypatch, [
            "render", "--scene", "cornell_box", "--width", "16", "--height",
            "8", "--roulette", mode])
        jr = JaxRenderer(jcfg, silent=True)
        jr.step()
        a = jr.state.accum
        want = np.stack([np.asarray(c) for c in (a.x, a.y, a.z)])
        r = OfflineRenderer(cfg, silent=True)
        r.step()
        np.testing.assert_allclose(r.accum.numpy(), want, rtol=1e-4,
                                   atol=1e-5, err_msg=mode)
        means[mode] = float(want.mean())
    assert len({round(m, 4) for m in means.values()}) == 3, means
