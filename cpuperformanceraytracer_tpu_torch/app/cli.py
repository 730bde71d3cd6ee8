"""Command line: ``render``, ``bench-grad`` and ``inverse``.

    python -m cpuperformanceraytracer_tpu_torch.app.cli render \\
        --scene glass_spheres --width 1280 --height 720 --frames 64 \\
        --bounces 8 --env procedural -o out.png
    python -m cpuperformanceraytracer_tpu_torch.app.cli bench-grad
    python -m cpuperformanceraytracer_tpu_torch.app.cli inverse --steps 60

``render`` prints ``NN ms/frame; NN Mrays/s; wrote <path>`` (primary
rays, W*H*spp per frame). ``bench-grad`` prints one JSON line: the timed
fwd+bwd step of ``diff/benchgrad.py``. ``inverse`` recovers perturbed
albedos and sphere centers by Adam and prints the loss before and after.
The two gradient commands use the counter RNG. ``--env`` is ``none``
(constant ambient), ``procedural`` (a 512x256 gradient sky) or a path to
a Radiance .hdr equirect map. ``--backend cuda`` (the default) runs the
CUDA kernels on the GPU; ``--backend torch`` the plain-torch versions on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from cpuperformanceraytracer_tpu_torch.config import RenderConfig, resolve_device


def _texture(env: str, device):
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import (
        load_texture,
        texture_from_array,
    )

    if env == "none":
        return None
    if env == "procedural":
        return texture_from_array(gradient_sky(512, 256), device)
    return load_texture(env, device)


def _cfg(a, **kw) -> RenderConfig:
    return RenderConfig(
        width=a.width, height=a.height, bounces=a.bounces, spp=a.spp,
        scene=a.scene, env_mode="none" if a.env == "none" else "equirect",
        env_sampling=a.env_sampling, backend=a.backend, **kw).validate()


def _problem(a, cfg):
    """(device, scene, camera, texture) of a gradient command."""
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    device = resolve_device(cfg.backend)
    scene, cam = scene_by_name(cfg.scene, device=device)
    return device, scene, cam, _texture(a.env, device)


def cmd_render(a) -> int:
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer

    cfg = _cfg(a, num_frames=a.frames)
    r = OfflineRenderer(cfg, texture=_texture(a.env, "cpu"))
    timer = r.run()
    r.write_image(a.output)
    rays = cfg.width * cfg.height * cfg.spp
    print(f"{timer.mean_ms:.3f} ms/frame; "
          f"{timer.rays_per_second(rays) / 1e6:.1f} Mrays/s; "
          f"wrote {a.output}")
    return 0


def cmd_bench_grad(a) -> int:
    """Timed fwd+bwd (loss and gradients of the L2 pixel loss) over sphere
    centers, albedos and env texels."""
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import fwd_bwd_benchmark

    cfg = _cfg(a, rng="counter")
    _, scene, cam, tex = _problem(a, cfg)
    result = fwd_bwd_benchmark(cfg, scene, cam, tex, steps=a.steps)
    out = {"metric": "fwd_bwd_ms_per_step",
           "config": f"{cfg.width}x{cfg.height} spp{cfg.spp} "
                     f"b{cfg.bounces} env={cfg.env_mode} {cfg.backend}"}
    out.update({k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in result.items()})
    print(json.dumps(out))
    return 0


def cmd_inverse(a) -> int:
    import torch

    from cpuperformanceraytracer_tpu_torch.diff.grad import render_for_params
    from cpuperformanceraytracer_tpu_torch.diff.inverse import (
        InverseProblem,
        adam_inverse_render,
    )

    cfg = _cfg(a, rng="counter")
    _, scene, cam, tex = _problem(a, cfg)
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    m, s = scene.materials.albedo, scene.spheres.center
    albedo = torch.stack([m.x, m.y, m.z], -1)
    centers = torch.stack([s.x, s.y, s.z], -1)
    init = {"albedo": torch.clamp(albedo + 0.2, 0.0, 1.0),
            "sphere_centers": centers + 0.3}
    params, losses = adam_inverse_render(
        InverseProblem(scene, cam, tex, cfg, target), init, steps=a.steps,
        learning_rate=a.lr, eps=a.eps)
    print(f"inverse render: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"albedo err {(params['albedo'] - albedo).abs().max().item():.4f}; "
          f"center err "
          f"{(params['sphere_centers'] - centers).abs().max().item():.4f}")
    return 0


def _add_common(p) -> None:
    p.add_argument("--scene", default="glass_spheres")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--env", default="procedural",
                   help="'none', 'procedural', or a .hdr path")
    p.add_argument("--env-sampling", default="stochastic",
                   choices=["stochastic", "nearest", "bilinear"])
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cprt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="offline progressive render")
    _add_common(p)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("-o", "--output", default="output_image.bmp")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench-grad", help="timed fwd+bwd step throughput")
    _add_common(p)
    p.add_argument("--steps", type=int, default=64)
    p.set_defaults(fn=cmd_bench_grad)

    p = sub.add_parser("inverse", help="inverse-rendering demo")
    _add_common(p)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--eps", type=float, default=1e-8,
                   help="Adam epsilon; ~1e-2 acts as a gradient noise "
                        "floor for geometry recovery")
    p.set_defaults(fn=cmd_inverse)

    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except (ValueError, NotImplementedError, FileNotFoundError,
            RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
