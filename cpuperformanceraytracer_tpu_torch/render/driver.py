"""Offline render driver: warmup, timed progressive loop, image output.

Counterpart of ``cpuperformanceraytracer_tpu.render.driver
.OfflineRenderer`` (the reference's offline benchmark protocol): warmup
frames into a scratch accumulator, then ``num_frames`` progressive
frames timed on the host clock between device synchronisations, ms/frame
and primary rays/s (W*H*spp per frame).

``backend="cuda"`` (the default) runs the CUDA kernels and needs a GPU:
without one the constructor raises, it never falls back to the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.config import resolve_device
from cpuperformanceraytracer_tpu_torch.io.image import write_bmp, write_png
from cpuperformanceraytracer_tpu_torch.render.frame import (
    make_frame_fn,
    postprocess_image,
    zero_accum,
)
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture
from cpuperformanceraytracer_tpu_torch.utils.timing import FrameTimer

# frames enqueued between two synchronisations of the timed loop
SYNC_EVERY = 64


class OfflineRenderer:
    """Progressive offline renderer over a scene preset (or a given
    scene and camera) on one device."""

    def __init__(self, cfg, texture: Optional[Texture] = None, scene=None,
                 camera=None, device=None):
        self.cfg = cfg.validate()
        self.device = resolve_device(self.cfg.backend, device)
        if scene is None or camera is None:
            scene, camera = scene_by_name(self.cfg.scene, device=self.device)
        if self.cfg.env_mode != "none":
            if texture is None:
                raise ValueError(f"env_mode {self.cfg.env_mode!r} needs a texture")
            texture = Texture(*(t.to(self.device).contiguous()
                                for t in texture[:3]),
                              texture.width, texture.height)
        self.scene, self.camera, self.texture = scene, camera, texture
        self.frame_fn = make_frame_fn(self.cfg, scene, camera, self.device)
        self.accum = zero_accum(self.cfg, self.device)
        self.frame = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        """One progressive frame (the accumulator updates in place)."""
        self.frame_fn(self.texture, self.frame, self.accum)
        self.frame += 1

    def run(self) -> FrameTimer:
        """Warmup, then the timed loop of ``cfg.num_frames`` frames."""
        cfg = self.cfg
        if cfg.warmup_frames > 0:
            # warm into a scratch accumulator so the image equals an
            # unwarmed run's
            keep = (self.accum, self.frame)
            self.accum, self.frame = zero_accum(cfg, self.device), 0
            for _ in range(cfg.warmup_frames):
                self.step()
            self._sync()
            self.accum, self.frame = keep

        timer = FrameTimer()
        done = 0
        while done < cfg.num_frames:
            todo = min(SYNC_EVERY, cfg.num_frames - done)
            t0 = time.perf_counter()
            for _ in range(todo):
                self.step()
            self._sync()
            timer.add_span(time.perf_counter() - t0, todo)
            done += todo
        return timer

    def image_u8(self) -> np.ndarray:
        return postprocess_image(self.accum, self.cfg.exposure).cpu().numpy()

    def write_image(self, path: str) -> None:
        img = self.image_u8()
        if path.endswith(".png"):
            write_png(path, img)
        else:
            write_bmp(path, img)

    def screenshot(self, directory: str = ".",
                   prefix: str = "screenshot") -> str:
        """Timestamped BMP of the current accumulation; returns its path."""
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(directory,
                            f"{prefix}_{stamp}_frame{self.frame}.bmp")
        self.write_image(path)
        return path
