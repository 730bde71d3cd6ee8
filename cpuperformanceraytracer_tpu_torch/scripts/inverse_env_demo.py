"""BASELINE config 4 at scale: recover the material albedos and every
texel of the env map from one rendered target.

Counterpart of the JAX package's ``scripts/inverse_env_demo.py``, at its
size: 256x144, spp 2, 3 bounces, the counter RNG, a stochastic equirect
env of ``gradient_sky(512, 256)`` (the 131072 texels of the JAX script's
``HDR_040_Field_Env.hdr``, which is not in the repo). The albedos start
at the truth + 0.2 (clipped to [0, 1]) and every texel at 0.5; Adam at
lr 0.02 runs K = 16 steps a dispatch (one CUDA graph on the card). Then
a fresh K-step function runs 3 warm chunks and 4 timed ones: the
steady-state ms/step. It prints the JAX script's three lines and one
JSON line with the same numbers unrounded.

    python -m cpuperformanceraytracer_tpu_torch.scripts.inverse_env_demo \\
        [STEPS] [--backend cuda|torch] [--width W --height H]

The albedos do not return to the truth: the floor's rises well above
it, as in the JAX script (``tests/test_torch_drivers.py`` holds the two
trajectories together at a small size), and the spheres' never move
(every path through a sphere refracts, so none reads its albedo).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from cpuperformanceraytracer_tpu_torch.config import RenderConfig, resolve_device
from cpuperformanceraytracer_tpu_torch.diff.grad import render_for_params
from cpuperformanceraytracer_tpu_torch.diff.inverse import (
    InverseProblem,
    adam_inverse_render,
    make_train_step_k,
)
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import (
    texture_from_array,
    texture_to,
)
from cpuperformanceraytracer_tpu_torch.utils.timing import device_name

DEMO = RenderConfig(width=256, height=144, spp=2, bounces=3,
                    scene="glass_spheres", env_mode="equirect",
                    env_sampling="stochastic", rng="counter")
K = 16              # Adam steps a dispatch
LEARNING_RATE = 0.02


def initial_params(scene, tex) -> dict:
    """The demo's start: the albedos + 0.2 (clipped to [0, 1]) and every
    texel at 0.5."""
    m = scene.materials.albedo
    albedo = torch.stack([m.x, m.y, m.z], -1)
    return {"albedo": torch.clamp(albedo + 0.2, 0.0, 1.0),
            "env_rgb": torch.full((tex.width * tex.height, 3), 0.5,
                                  dtype=torch.float32, device=albedo.device)}


def inverse_env(cfg, texture, steps: int = 200, warm_chunks: int = 3,
                timed_chunks: int = 4, device=None) -> dict:
    """Run the demo; returns its numbers, the loss trajectory and the
    recovered parameters (``params``). ``device`` is where the ``torch``
    backend runs (the CPU if None)."""
    device = resolve_device(cfg.backend, device)
    scene, cam = scene_by_name(cfg.scene, device=device)
    tex = texture_to(texture, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    m = scene.materials.albedo
    albedo = torch.stack([m.x, m.y, m.z], -1)
    init = initial_params(scene, tex)
    prob = InverseProblem(scene, cam, tex, cfg, target)
    sync()
    t0 = time.perf_counter()
    params, losses = adam_inverse_render(prob, init, steps=steps,
                                         learning_rate=LEARNING_RATE,
                                         steps_per_dispatch=K)
    sync()
    wall = time.perf_counter() - t0

    # steady state: a fresh K-step function (its own graph) on a copy
    p = {n: v.clone().requires_grad_() for n, v in params.items()}
    adam = torch.optim.Adam(list(p.values()), lr=LEARNING_RATE,
                            capturable=device.type == "cuda")
    step_k = make_train_step_k(prob, adam, K)
    for _ in range(warm_chunks):
        step_k(p, 0)
        sync()
    t0 = time.perf_counter()
    for c in range(timed_chunks):
        step_k(p, K * c)
    sync()
    steady = (time.perf_counter() - t0) / (timed_chunks * K) * 1e3

    return {
        "config": f"{cfg.width}x{cfg.height} spp{cfg.spp} b{cfg.bounces} "
                  f"env {tex.width}x{tex.height}",
        "steps": steps, "steps_per_dispatch": K,
        "loss_first": losses[0], "loss_last": losses[-1],
        "ms_per_step_incl_compile": wall / steps * 1e3,
        "ms_per_step_steady": steady,
        "steady_steps": timed_chunks * K,
        "albedo_max_err": (params["albedo"] - albedo).abs().max().item(),
        "albedo_err_by_material": (params["albedo"] - albedo).abs()
        .amax(-1).tolist(),
        "params_finite": all(bool(torch.isfinite(v).all())
                             for v in params.values()),
        "device": device_name(device),
        "losses": losses, "params": params,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="inverse_env_demo")
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--width", type=int, default=DEMO.width)
    ap.add_argument("--height", type=int, default=DEMO.height)
    a = ap.parse_args(argv)
    cfg = DEMO.replace(width=a.width, height=a.height, backend=a.backend)
    r = inverse_env(cfg, texture_from_array(gradient_sky(512, 256)),
                    steps=a.steps)
    print(f"{r['steps']} steps in "
          f"{r['ms_per_step_incl_compile'] * r['steps'] / 1e3:.1f} s = "
          f"{r['ms_per_step_incl_compile']:.1f} ms/step (incl. compile); "
          f"loss {r['loss_first']:.4f} -> {r['loss_last']:.5f}")
    print(f"steady-state: {r['ms_per_step_steady']:.2f} ms/step")
    print(f"albedo max err {r['albedo_max_err']:.4f}; grads finite "
          f"{r['params_finite']}")
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("losses", "params")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
