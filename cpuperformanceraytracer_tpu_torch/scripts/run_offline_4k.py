"""BASELINE config 5: 3840x2160, 1024 progressive frames of 1 spp, with
a real checkpoint and a resume in a fresh renderer.

Counterpart of the JAX package's ``scripts/run_offline_4k.py``. Phase 1
renders the first half of the frames, saving a checkpoint every 128;
the renderer is then dropped (a preemption), and phase 2 builds a fresh
one, resumes from the checkpoint and renders the rest. It writes the
image through kernel G and prints one JSON line with the JAX script's
keys (``ms_per_frame`` over both phases' timed frames, ``Mrays_per_s``
of primary rays, each phase's wall seconds, set-up and saves included),
plus ``checkpoint_save_s``, the seconds the saves took outside the timed
spans, and ``device``.

    python -m cpuperformanceraytracer_tpu_torch.scripts.run_offline_4k \\
        [OUT.png] [--backend cuda|torch] [--width W --height H \\
        --frames N --checkpoint-every K]

The env map is ``gradient_sky(512, 256)``, which has the 131072 texels
of the JAX script's ``HDR_040_Field_Env.hdr`` (not in the repo).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from cpuperformanceraytracer_tpu_torch.config import BENCH_CONFIGS
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.utils.timing import device_name


def run_offline(cfg, texture, out: str, checkpoint_every: int = 128):
    """Render ``cfg.num_frames`` frames in two phases with a resume
    between them; returns (the JSON line's dict, the final
    ``RenderState``). The checkpoint is ``out + ".ckpt.npz"``."""
    ck = out + ".ckpt.npz"
    if os.path.exists(ck):
        os.remove(ck)
    half = cfg.num_frames // 2

    t0 = time.perf_counter()
    r1 = OfflineRenderer(cfg.replace(num_frames=half), texture=texture,
                         silent=True)
    t1 = r1.run(checkpoint_path=ck, checkpoint_every=checkpoint_every)
    wall1 = time.perf_counter() - t0
    if not os.path.exists(ck):
        raise RuntimeError("phase 1 wrote no checkpoint")
    device = device_name(r1.device)
    del r1  # a preemption: all in-memory state gone

    t0 = time.perf_counter()
    r2 = OfflineRenderer(cfg.replace(num_frames=half), texture=texture,
                         silent=True)
    r2.resume(ck)
    resumed_at = r2.state.frame
    # continue to the full frame count (the frame step does not read it)
    r2.cfg = r2.cfg.replace(num_frames=cfg.num_frames - resumed_at)
    t2 = r2.run(checkpoint_path=ck, checkpoint_every=checkpoint_every)
    wall2 = time.perf_counter() - t0
    r2.write_image(out)

    rays = cfg.width * cfg.height * cfg.spp
    ms = (t1.mean_ms * t1.timed_frames + t2.mean_ms * t2.timed_frames) / (
        t1.timed_frames + t2.timed_frames)
    summary = {
        "config": "offline_4k",
        "frames_total": resumed_at + t2.timed_frames,
        "resumed_at_frame": resumed_at,
        "ms_per_frame": ms,
        "Mrays_per_s": rays / ms / 1e3,
        "wall_s_phase1": wall1,
        "wall_s_phase2": wall2,
        "checkpoint_save_s": t1.checkpoint_s + t2.checkpoint_s,
        "image": out,
        "device": device,
    }
    return summary, r2.state


def main(argv=None) -> int:
    base = BENCH_CONFIGS["offline_4k"]
    ap = argparse.ArgumentParser(prog="run_offline_4k")
    ap.add_argument("out", nargs="?", default="build/offline_4k.png")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--width", type=int, default=base.width)
    ap.add_argument("--height", type=int, default=base.height)
    ap.add_argument("--frames", type=int, default=base.num_frames)
    ap.add_argument("--checkpoint-every", type=int, default=128)
    a = ap.parse_args(argv)
    cfg = base.replace(width=a.width, height=a.height, num_frames=a.frames,
                       backend=a.backend)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    summary, _ = run_offline(cfg, texture_from_array(gradient_sky(512, 256)),
                             a.out, a.checkpoint_every)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
