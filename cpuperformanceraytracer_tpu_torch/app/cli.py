"""Command line: ``render``, ``watch``, ``bench``, ``bench-grad`` and
``inverse``.

    python -m cpuperformanceraytracer_tpu_torch.app.cli render \\
        --scene glass_spheres --width 1280 --height 720 --frames 600 \\
        --bounces 8 --env procedural -o out.png
    python -m cpuperformanceraytracer_tpu_torch.app.cli watch --interval 8
    python -m cpuperformanceraytracer_tpu_torch.app.cli bench textured_1080
    python -m cpuperformanceraytracer_tpu_torch.app.cli bench-grad
    python -m cpuperformanceraytracer_tpu_torch.app.cli inverse --steps 60

``render`` prints ``NN ms/frame; NN Mrays/s; wrote <path>`` (primary
rays, W*H*spp per frame); ``--checkpoint PATH`` resumes from PATH when
its image fingerprint matches and, with ``--checkpoint-every K``, saves
there every K frames (the JAX package's format). ``watch`` renders
progressively, rewrites the output image every ``--interval`` frames and
prints a stats line (``--live``: the image in the terminal, ANSI
truecolor); keys on a tty: ``s`` writes a timestamped screenshot, ``q``
stops. ``bench`` runs named configs (``config.BENCH_CONFIGS``) and prints
one JSON line each, naming the env texture (a procedural sky). ``bench-grad`` prints one
JSON line: the timed fwd+bwd step of ``diff/benchgrad.py``, K steps a
dispatch (``--steps-per-dispatch``: 16 by default, one CUDA graph of K
steps on the card; 1 is the per-step loop). ``inverse``
recovers perturbed albedos and sphere centers by Adam, logs the loss
every 10 steps on stderr (unless ``--silent``) and prints the loss before
and after. The two gradient commands use the counter RNG.

The options and their defaults are the JAX package's CLI's. With no
``--env`` (or ``--env none``) the miss radiance is the constant ambient;
``--env procedural`` is a 512x256 gradient sky, any other value a path to
a Radiance .hdr equirect map; ``--cubemap`` takes six .hdr faces (px nx
py ny pz nz) instead. ``--roulette`` is ``v4_quirk`` (the default),
``terminate`` or ``off``; ``render`` and ``watch`` run 600 frames unless
``--frames`` says otherwise. ``--backend cuda`` (the
default) runs the CUDA kernels on the GPU; ``--backend torch`` the
plain-torch versions on the CPU; ``--backend oracle`` the oracle
integrator on the CPU (``render/integrator.py``; on ``bench-grad`` with
path replay, 4 steps and K = 1 by default, as the JAX package's ``xla``).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys

from cpuperformanceraytracer_tpu_torch.config import (
    BACKENDS,
    BENCH_CONFIGS,
    RenderConfig,
    resolve_device,
)


def _texture(a, device):
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import (
        load_cubemap_texture,
        load_texture,
        texture_from_array,
    )

    if a.cubemap:
        return load_cubemap_texture(a.cubemap, device)
    if a.env in (None, "none"):
        return None
    if a.env == "procedural":
        return texture_from_array(gradient_sky(512, 256), device)
    return load_texture(a.env, device)


def _cfg(a, **kw) -> RenderConfig:
    env_mode = ("cubemap" if a.cubemap
                else "none" if a.env in (None, "none") else "equirect")
    return RenderConfig(
        width=a.width, height=a.height, bounces=a.bounces, spp=a.spp,
        scene=a.scene, env_mode=env_mode, env_sampling=a.env_sampling,
        roulette=a.roulette, backend=a.backend, **kw).validate()


def _render_cfg(a) -> RenderConfig:
    return _cfg(a, rng=a.rng, num_frames=a.frames, warmup_frames=a.warmup,
                exposure=a.exposure)


def _problem(a, cfg):
    """(device, scene, camera, texture) of a gradient command."""
    from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name

    device = resolve_device(cfg.backend)
    scene, cam = scene_by_name(cfg.scene, device=device)
    return device, scene, cam, _texture(a, device)


def cmd_render(a) -> int:
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer

    cfg = _render_cfg(a)
    r = OfflineRenderer(cfg, texture=_texture(a, "cpu"), silent=a.silent)
    if a.checkpoint:
        r.resume(a.checkpoint)
    timer = r.run(checkpoint_path=a.checkpoint,
                  checkpoint_every=a.checkpoint_every)
    r.write_image(a.output)
    rays = cfg.width * cfg.height * cfg.spp
    print(f"{timer.mean_ms:.3f} ms/frame; "
          f"{timer.rays_per_second(rays) / 1e6:.1f} Mrays/s; "
          f"wrote {a.output}")
    return 0


def _poll_keys() -> str:
    """Pending stdin characters, without blocking ('' when stdin is not a
    tty or nothing is pending)."""
    import select

    if not sys.stdin.isatty():
        return ""
    keys = ""
    while select.select([sys.stdin], [], [], 0)[0]:
        ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
        if not ch:
            break
        keys += ch
    return keys


@contextlib.contextmanager
def _cbreak():
    """Single keypresses without Enter while watching (a tty only); the
    terminal's mode is restored on exit."""
    if not sys.stdin.isatty():
        yield
        return
    import termios
    import tty

    old = termios.tcgetattr(sys.stdin.fileno())
    try:
        tty.setcbreak(sys.stdin.fileno())
        yield
    finally:
        termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, old)


def cmd_watch(a) -> int:
    """Progressive render with a live view: the output file is rewritten
    every --interval frames, with a stats line (the reference window's
    title bar: the mean over the last 30 frames)."""
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.utils.term_view import live_view
    from cpuperformanceraytracer_tpu_torch.utils.timing import Timer

    if a.interval < 1:
        raise ValueError("--interval must be >= 1")
    cfg = _render_cfg(a)
    r = OfflineRenderer(cfg, texture=_texture(a, "cpu"), silent=a.silent)
    rays = cfg.width * cfg.height * cfg.spp
    r.warmup()
    window = collections.deque(maxlen=30)
    first = True
    with _cbreak():
        for start in range(0, cfg.num_frames, a.interval):
            todo = min(a.interval, cfg.num_frames - start)
            with Timer() as t:
                for _ in range(todo):
                    r.step()
                r.sync()
            window.extend([t.ms / todo] * todo)
            roll_ms = sum(window) / len(window)
            r.write_image(a.output)
            keys = _poll_keys()
            note = f" | screenshot: {r.screenshot()}" if "s" in keys else ""
            stats = (f"frame {start + todo}/{cfg.num_frames} | "
                     f"{roll_ms:7.2f} ms/frame | {1e3 / roll_ms:6.1f} fps | "
                     f"{rays / roll_ms / 1e3:7.1f} Mrays/s | {a.output}{note}")
            if a.live:
                print(live_view(r.image_u8(), stats, first=first), flush=True)
                first = False
            elif not a.silent:
                print(stats, flush=True)
            if "q" in keys:
                break
    return 0


# the procedural sky of each bench config: the texel count of the texture
# the JAX preset names (textured_1080: chinese_garden_2k), 512x256 (the
# JAX bench's own sky) otherwise
BENCH_SKY = {"textured_1080": (2048, 1024)}


def cmd_bench(a) -> int:
    """Named configs, one JSON line each: ms/frame and primary Mrays/s
    over --frames timed frames after the config's warmup."""
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array
    from cpuperformanceraytracer_tpu_torch.utils.timing import device_name

    names = a.configs or [k for k in BENCH_CONFIGS
                          if k not in ("inverse_render", "offline_4k")]
    unknown = [n for n in names if n not in BENCH_CONFIGS]
    if unknown:
        raise ValueError(f"unknown bench config(s) {unknown}; choose from "
                         f"{sorted(BENCH_CONFIGS)}")
    for name in names:
        cfg = BENCH_CONFIGS[name].replace(num_frames=a.frames,
                                          backend=a.backend)
        tex = env_tex = None
        if cfg.env_mode != "none":
            tex_w, tex_h = BENCH_SKY.get(name, (512, 256))
            tex = texture_from_array(gradient_sky(tex_w, tex_h))
            env_tex = f"procedural_{tex_w}x{tex_h}"
        r = OfflineRenderer(cfg, texture=tex, silent=True)
        t = r.run()
        rays = cfg.width * cfg.height * cfg.spp
        print(json.dumps({
            "config": name, "ms_per_frame": round(t.mean_ms, 3),
            "Mrays_per_s": round(t.rays_per_second(rays) / 1e6, 2),
            "env_texture": env_tex, "frames": t.timed_frames,
            "size": f"{cfg.width}x{cfg.height} spp{cfg.spp} b{cfg.bounces}",
            "backend": cfg.backend, "device": device_name(r.device)}),
            flush=True)
    return 0


def cmd_bench_grad(a) -> int:
    """Timed fwd+bwd (loss and gradients of the L2 pixel loss) over sphere
    centers, albedos and env texels."""
    from cpuperformanceraytracer_tpu_torch.diff.benchgrad import fwd_bwd_benchmark

    cfg = _cfg(a, rng="counter")
    steps, k = 64, 16
    if cfg.backend == "oracle":
        # path replay (diff/path_replay.py) takes seconds a step at 720p:
        # a small default protocol unless the caller sized it
        cfg = cfg.replace(remat_bounces=True)
        steps, k = 4, 1
    _, scene, cam, tex = _problem(a, cfg)
    result = fwd_bwd_benchmark(
        cfg, scene, cam, tex, steps=steps if a.steps is None else a.steps,
        steps_per_dispatch=k if a.steps_per_dispatch is None
        else a.steps_per_dispatch)
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
    from cpuperformanceraytracer_tpu_torch.utils.log import get_logger

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
        learning_rate=a.lr, eps=a.eps, log_every=10,
        logger=get_logger(silent=a.silent))
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
    p.add_argument("--env", default=None,
                   help="'procedural', a .hdr path, or 'none' or omitted "
                        "for the constant ambient")
    p.add_argument("--cubemap", nargs=6, default=None,
                   metavar=("PX", "NX", "PY", "NY", "PZ", "NZ"),
                   help="six .hdr faces: a cubemap env instead of --env")
    p.add_argument("--env-sampling", default="stochastic",
                   choices=["stochastic", "nearest", "bilinear"])
    p.add_argument("--roulette", default="v4_quirk",
                   choices=["off", "terminate", "v4_quirk"])
    p.add_argument("--backend", default="cuda", choices=list(BACKENDS))


def _add_render(p) -> None:
    _add_common(p)
    p.add_argument("--rng", default="wang", choices=["wang", "counter"],
                   help="counter is needed for spp > 1 with an env map")
    p.add_argument("--frames", type=int, default=600)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("-o", "--output", default="output_image.bmp")
    p.add_argument("--silent", action="store_true")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cprt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="offline progressive render")
    _add_render(p)
    p.add_argument("--checkpoint", default=None,
                   help="resume from / save to this .npz")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save every K frames (with --checkpoint)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("watch", help="progressive render with live file updates")
    _add_render(p)
    p.add_argument("--interval", type=int, default=10)
    p.add_argument("--live", action="store_true",
                   help="draw the frame in the terminal (ANSI truecolor)")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("bench", help="run named benchmark configs")
    p.add_argument("configs", nargs="*", default=None)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("bench-grad", help="timed fwd+bwd step throughput")
    _add_common(p)
    p.add_argument("--steps", type=int, default=None,
                   help="timed steps (default 64; 4 with --backend oracle)")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="K steps a dispatch, one CUDA graph on the card "
                        "(default 16; 1 with --backend oracle; 1 is the "
                        "per-step loop)")
    p.set_defaults(fn=cmd_bench_grad)

    p = sub.add_parser("inverse", help="inverse-rendering demo")
    _add_common(p)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--eps", type=float, default=1e-8,
                   help="Adam epsilon; ~1e-2 acts as a gradient noise "
                        "floor for geometry recovery")
    p.add_argument("--silent", action="store_true",
                   help="no progress lines (every 10 steps otherwise)")
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
