"""The port's drivers of BASELINE configs 4 and 5 and of the headline
metric, on the CPU at test sizes (the ``torch`` backend: the plain
kernels), against the JAX package.

- ``scripts/run_offline_4k.run_offline`` (config 5's protocol) at 32x16,
  8 frames, a checkpoint every 2: the resumed accumulator and image are
  bit-equal to one uninterrupted run without checkpoints, and the
  accumulator agrees with JAX's ``OfflineRenderer`` taken through the
  same checkpoint and resume (its ``xla`` route) under the repo's glass
  policy (robust statistics: ``torch_port_helpers.assert_robust``).
- ``scripts/inverse_env_demo.inverse_env`` (config 4) at 32x16, 1
  bounce, a 16x8 env, 3 steps: the loss trajectory against JAX's
  ``adam_inverse_render`` over the albedos and every env texel (``xla``)
  at rtol 1e-3; and at 3 bounces, a 64x32 env, 64 steps: the albedos
  that leave the truth in JAX (the floor's) leave it in the port alike.
- ``bench.main`` prints one JSON line with the root ``bench.py``'s keys,
  ``device`` added and ``vs_baseline`` left out.
"""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_robust
from cpuperformanceraytracer_tpu.config import BENCH_CONFIGS as JAX_BENCH
from cpuperformanceraytracer_tpu.config import RenderConfig as JaxConfig
from cpuperformanceraytracer_tpu.diff import grad as jgrad
from cpuperformanceraytracer_tpu.diff import inverse as jinv
from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer as JaxRenderer
from cpuperformanceraytracer_tpu.scene.presets import glass_spheres_scene
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import (
    texture_from_array as jax_texture,
)
from cpuperformanceraytracer_tpu_torch import bench
from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.scripts.inverse_env_demo import (
    DEMO,
    inverse_env,
)
from cpuperformanceraytracer_tpu_torch.scripts.inverse_env_demo import (
    main as inverse_main,
)
from cpuperformanceraytracer_tpu_torch.scripts.run_offline_4k import (
    main as offline_main,
)
from cpuperformanceraytracer_tpu_torch.scripts.run_offline_4k import run_offline
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

ROOT = Path(__file__).resolve().parents[1]
OFFLINE_KEYS = {"config", "frames_total", "resumed_at_frame", "ms_per_frame",
                "Mrays_per_s", "wall_s_phase1", "wall_s_phase2", "image",
                "checkpoint_save_s", "device"}


def test_run_offline_resume_bit_equal_and_as_jax(tmp_path):
    sky = gradient_sky(64, 32)
    cfg = BENCH_CONFIGS["offline_4k"].replace(width=32, height=16,
                                              num_frames=8, backend="torch")
    out = str(tmp_path / "offline.png")
    summary, state = run_offline(cfg, texture_from_array(sky), out,
                                 checkpoint_every=2)
    assert set(summary) == OFFLINE_KEYS
    assert summary["frames_total"] == 8 and summary["resumed_at_frame"] == 4
    assert summary["device"] == "cpu" and summary["ms_per_frame"] > 0
    assert state.frame == 8

    whole = OfflineRenderer(cfg, texture=texture_from_array(sky), silent=True)
    whole.run()
    assert torch.equal(state.accum, whole.accum)
    whole.write_image(str(tmp_path / "whole.png"))
    assert (tmp_path / "whole.png").read_bytes() == Path(out).read_bytes()

    # JAX's renderer through the same phases: 4 frames, a checkpoint every
    # 2, a fresh renderer resumed for the rest
    jcfg = JAX_BENCH["offline_4k"].replace(width=32, height=16, num_frames=4,
                                           backend="xla")
    jtex = jax_texture(sky)
    ck = str(tmp_path / "jax.npz")
    JaxRenderer(jcfg, texture=jtex, silent=True).run(checkpoint_path=ck,
                                                     checkpoint_every=2)
    jr = JaxRenderer(jcfg, texture=jtex, silent=True)
    jr.resume(ck)
    assert jr.state.frame == summary["resumed_at_frame"]
    jr.cfg = jr.cfg.replace(num_frames=8 - jr.state.frame)
    jr.run(checkpoint_path=ck, checkpoint_every=2)
    assert jr.state.frame == state.frame
    a = jr.state.accum
    want = np.stack([np.asarray(c) for c in (a.x, a.y, a.z)])
    for c in range(3):
        assert_robust(state.accum[c].numpy(), want[c], what=f"channel {c}")


def _jax_inverse(sky, width, height, bounces, steps):
    """JAX's config-4 run (``xla``) at a test size: (params, losses,
    true albedos)."""
    jcfg = JaxConfig(width=width, height=height, spp=2, bounces=bounces,
                     scene="glass_spheres", env_mode="equirect",
                     env_sampling="stochastic", rng="counter", backend="xla")
    scene, cam = glass_spheres_scene()
    jtex = jax_texture(sky)
    target = jgrad.render_for_params({}, scene, cam, jtex, jcfg, 0)
    m = scene.materials.albedo
    albedo = jnp.stack([m.x, m.y, m.z], -1)
    init = {"albedo": jnp.clip(albedo + 0.2, 0.0, 1.0),
            "env_rgb": jnp.full((sky.shape[0] * sky.shape[1], 3), 0.5,
                                jnp.float32)}
    params, losses = jinv.adam_inverse_render(
        jinv.InverseProblem(scene, cam, jtex, jcfg, target), init,
        steps=steps, learning_rate=0.02, steps_per_dispatch=16)
    return params, losses, np.asarray(albedo)


def test_inverse_env_losses_as_jax():
    sky = gradient_sky(16, 8)
    cfg = DEMO.replace(width=32, height=16, bounces=1, backend="torch")
    r = inverse_env(cfg, texture_from_array(sky), steps=3, warm_chunks=1,
                    timed_chunks=1)
    assert r["params"]["env_rgb"].shape == (16 * 8, 3)
    assert r["params_finite"] and r["loss_last"] < r["loss_first"]
    assert r["steady_steps"] == 16 and r["ms_per_step_steady"] > 0

    _, want, _ = _jax_inverse(sky, 32, 16, 1, 3)
    np.testing.assert_allclose(r["losses"], want, rtol=1e-3)


def test_inverse_env_albedos_drift_as_jax():
    """The demo's albedos move away from the truth in JAX as in the port:
    at the demo's 3 bounces, 64 steps (4 dispatches of 16), the floor's
    albedo is more than 1 from the truth in both, the spheres' have not
    moved, and the port's albedos and losses are JAX's at rtol 1e-3
    (atol 1e-4 for the albedos near 0)."""
    sky = gradient_sky(64, 32)
    cfg = DEMO.replace(width=32, height=16, backend="torch")
    r = inverse_env(cfg, texture_from_array(sky), steps=64, warm_chunks=0,
                    timed_chunks=1)
    got = r["params"]["albedo"].detach().numpy()
    params, losses, truth = _jax_inverse(sky, 32, 16, DEMO.bounces, 64)
    want = np.asarray(params["albedo"])
    for albedo in (got, want):
        assert np.abs(albedo[0] - truth[0]).max() > 1.0       # the floor
        np.testing.assert_array_equal(albedo[4:],
                                      np.clip(truth[4:] + 0.2, 0.0, 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(r["losses"], losses, rtol=1e-3)


def _root_bench_keys():
    """The string keys of the dicts in the root ``bench.py``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
    return keys


def test_bench_prints_the_root_scripts_line(capsys):
    assert bench.main(["--backend", "torch", "--width", "32", "--height",
                       "16", "--bounces", "2", "--frames", "3",
                       "--grad-steps", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    want = _root_bench_keys()
    assert "vs_baseline" in want and "fwd_bwd_grads_finite" in want
    assert set(out) == (want - {"vs_baseline", "fwd_bwd_error"}) | {"device"}
    assert out["metric"] == "fwd_primary_Mrays_per_s_per_chip_32x16_2bounce"
    assert out["device"] == "cpu" and out["fwd_bwd_grads_finite"] is True
    assert len(out["fwd_bwd_span_ms"]) == 2


def test_bench_defaults_are_the_headline_workload():
    cfg = bench.HEADLINE
    assert (cfg.width, cfg.height, cfg.bounces, cfg.spp, cfg.rng,
            cfg.num_frames, cfg.warmup_frames, cfg.backend) == (
        1280, 720, 8, 1, "wang", 128, 2, "cuda")


@pytest.mark.parametrize("main,argv", [
    (bench.main, ["--frames", "1", "--grad-steps", "1"]),
    (offline_main, ["--width", "8", "--height", "8", "--frames", "2",
                    "--checkpoint-every", "1"]),
    (inverse_main, ["1"]),
])
def test_entry_points_need_the_card(tmp_path, monkeypatch, main, argv):
    """By default each entry point runs on the card; without one it
    raises (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: nothing to refuse")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        main(argv)
