"""The headline benchmark: one JSON line, the counterpart of the JAX
package's root ``bench.py``, on the card.

At the reference's default workload (1280x720, ``glass_spheres``, 8
bounces, 1 spp a frame, an equirect stochastic env of
``gradient_sky(512, 256)``, the 131072 texels of the reference HDR,
which is not in the repo):

1. ``value``: the forward frame's primary Mrays/s, the offline protocol
   (2 warmup frames, then the mean ms/frame of 128 timed frames, wang
   RNG; ``render/driver.py``);
2. ``fwd_bwd_ms_per_step`` / ``fwd_bwd_Mrays_per_s``: the value-and-grad
   of the L2 pixel loss over sphere centers, albedos and every env
   texel, counter RNG, K = 16 steps a dispatch (one CUDA graph), 6 warm
   calls, 64 timed steps in 2 spans (``diff/benchgrad.py``);
   ``fwd_bwd_spread`` is the spans' relative spread.

The keys are the JAX script's, with ``device`` (the card's name) and
without ``vs_baseline`` (its 500 Mrays/s was a TPU target). A failure
of either half raises.

    python -m cpuperformanceraytracer_tpu_torch.bench [--backend torch \\
        --width W --height H --bounces B --frames N --grad-steps N]
"""

from __future__ import annotations

import argparse
import json
import sys

from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff.benchgrad import fwd_bwd_benchmark
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.utils.timing import device_name

HEADLINE = RenderConfig(width=1280, height=720, spp=1, bounces=8,
                        scene="glass_spheres", env_mode="equirect",
                        env_sampling="stochastic", rng="wang",
                        num_frames=128, warmup_frames=2)


def headline(cfg, texture, grad_steps: int = 64) -> dict:
    """The forward frames of ``cfg``, then ``grad_steps`` timed fwd+bwd
    steps of ``cfg`` with the counter RNG; returns the JSON line's dict."""
    renderer = OfflineRenderer(cfg, texture=texture, silent=True)
    timer = renderer.run()
    rays = cfg.width * cfg.height * cfg.spp
    out = {
        "metric": f"fwd_primary_Mrays_per_s_per_chip_{cfg.width}x"
                  f"{cfg.height}_{cfg.bounces}bounce",
        "value": timer.rays_per_second(rays) / 1e6,
        "unit": "Mrays/s",
        "device": device_name(renderer.device),
    }
    g = fwd_bwd_benchmark(cfg.replace(rng="counter", num_frames=1),
                          renderer.scene, renderer.camera, renderer.texture,
                          steps=grad_steps)
    out.update({
        "fwd_bwd_ms_per_step": g["ms_per_step"],
        "fwd_bwd_Mrays_per_s": g["Mrays_per_s"],
        "fwd_bwd_spread": g["spread"],
        "fwd_bwd_span_ms": g["span_ms"],
        "fwd_bwd_grads_finite": g["grads_finite"],
    })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--width", type=int, default=HEADLINE.width)
    ap.add_argument("--height", type=int, default=HEADLINE.height)
    ap.add_argument("--bounces", type=int, default=HEADLINE.bounces)
    ap.add_argument("--frames", type=int, default=HEADLINE.num_frames)
    ap.add_argument("--grad-steps", type=int, default=64)
    a = ap.parse_args(argv)
    cfg = HEADLINE.replace(width=a.width, height=a.height, bounces=a.bounces,
                           num_frames=a.frames, backend=a.backend)
    out = headline(cfg, texture_from_array(gradient_sky(512, 256)),
                   a.grad_steps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
