"""Command line: ``render``, the offline progressive render.

    python -m cpuperformanceraytracer_tpu_torch.app.cli render \\
        --scene glass_spheres --width 1280 --height 720 --frames 64 \\
        --bounces 8 --env procedural --backend cuda -o out.png

prints ``NN ms/frame; NN Mrays/s; wrote <path>`` (primary rays,
W*H*spp per frame). ``--env`` is ``none`` (constant ambient),
``procedural`` (a 512x256 gradient sky) or a path to a Radiance .hdr
equirect map.
"""

from __future__ import annotations

import argparse
import sys

from cpuperformanceraytracer_tpu_torch.config import RenderConfig


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


def cmd_render(a) -> int:
    from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer

    cfg = RenderConfig(
        width=a.width, height=a.height, bounces=a.bounces,
        num_frames=a.frames, scene=a.scene,
        env_mode="none" if a.env == "none" else "equirect",
        backend=a.backend).validate()
    r = OfflineRenderer(cfg, texture=_texture(a.env, "cpu"))
    timer = r.run()
    r.write_image(a.output)
    rays = cfg.width * cfg.height * cfg.spp
    print(f"{timer.mean_ms:.3f} ms/frame; "
          f"{timer.rays_per_second(rays) / 1e6:.1f} Mrays/s; "
          f"wrote {a.output}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cprt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="offline progressive render")
    p.add_argument("--scene", default="glass_spheres")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--env", default="procedural",
                   help="'none', 'procedural', or a .hdr path")
    p.add_argument("--backend", default="torch", choices=["torch", "cuda"])
    p.add_argument("-o", "--output", default="output_image.bmp")
    p.set_defaults(fn=cmd_render)
    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except (ValueError, NotImplementedError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
