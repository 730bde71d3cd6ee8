"""Offline render driver: warmup, timed progressive loop, progress,
checkpoint/resume, image output.

Counterpart of ``cpuperformanceraytracer_tpu.render.driver
.OfflineRenderer`` (the reference's offline benchmark protocol): warmup
frames into a scratch accumulator, then ``num_frames`` progressive
frames timed on the host clock between device synchronisations, ms/frame
and primary rays/s (W*H*spp per frame). With a checkpoint path the loop
also synchronises on every ``checkpoint_every``-th frame and saves there
(``io/checkpoint.py``, the JAX package's format; the save is not timed);
``resume`` continues from a checkpoint. Images go through kernel G
(``render/frame.postprocess_image``). ``state`` is the JAX renderer's
``RenderState(accum, frame)``, here with the accumulator as one (3, H, W)
tensor; ``step_k(k)`` renders k frames in a loop (the JAX renderer fuses
them into one dispatch: the forward frame's device is idle 0.0098 of the
time here, so nothing is fused).

``backend="cuda"`` (the default) runs the CUDA kernels and needs a GPU:
without one the constructor raises, it never falls back to the CPU.

``mesh`` (a ``parallel.mesh.Mesh``) shards the frames over a world of
processes, as the JAX ``OfflineRenderer``'s ``mesh=``: each rank
renders and accumulates its own rows (``parallel/shard.make_rows_fn``),
and the whole
accumulator is assembled, by a collective every rank joins, only where
it is read: ``accum``, ``image_u8``, ``write_image``, ``screenshot`` and
a checkpoint save (rank 0 writes the files). The checkpoint keeps the
JAX format. Every rank times its own spans, with one synchronisation of
its device a span.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.config import resolve_device
from cpuperformanceraytracer_tpu_torch.io.checkpoint import (
    resume_or_fresh,
    save_checkpoint,
)
from cpuperformanceraytracer_tpu_torch.io.image import write_bmp, write_png
from cpuperformanceraytracer_tpu_torch.render.frame import (
    make_frame_fn,
    postprocess_image,
)
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture, texture_to
from cpuperformanceraytracer_tpu_torch.utils import profiling
from cpuperformanceraytracer_tpu_torch.utils.log import get_logger, progress
from cpuperformanceraytracer_tpu_torch.utils.timing import FrameTimer

# frames enqueued between two synchronisations of the timed loop
SYNC_EVERY = 64


@dataclasses.dataclass
class RenderState:
    """The progressive render's state: the (3, H, W) accumulator and the
    index of the next frame."""

    accum: torch.Tensor
    frame: int


class OfflineRenderer:
    """Progressive offline renderer over a scene preset (or a given
    scene and camera) on one device."""

    def __init__(self, cfg, texture: Optional[Texture] = None, scene=None,
                 camera=None, device=None, silent: bool = False, mesh=None):
        self.cfg = cfg.validate()
        self.log = get_logger(silent=silent)
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(self.cfg.backend, device)
        if scene is None or camera is None:
            scene, camera = scene_by_name(self.cfg.scene, device=self.device)
        if self.cfg.env_mode != "none":
            if texture is None:
                raise ValueError(f"env_mode {self.cfg.env_mode!r} needs a texture")
            texture = texture_to(texture, self.device)
        self.scene, self.camera, self.texture = scene, camera, texture
        if mesh is None:
            self.rows = (0, self.cfg.height)
            frame_fn = make_frame_fn(self.cfg, scene, camera, self.device)
        else:
            from cpuperformanceraytracer_tpu_torch.parallel.shard import (
                make_rows_fn,
                shard_window,
            )

            self.rows = shard_window(self.cfg, mesh)[:2]
            frame_fn = make_rows_fn(self.cfg, mesh, scene, camera)
        self.frame_fn = frame_fn
        self.local = self._zero_rows()  # this rank's rows of the accumulator
        self.frame = 0

    def _zero_rows(self) -> torch.Tensor:
        return torch.zeros((3, self.rows[1], self.cfg.width),
                           dtype=torch.float32, device=self.device)

    @property
    def accum(self) -> torch.Tensor:
        """The whole (3, H, W) accumulator (under a mesh, assembled from
        every rank's rows: a collective)."""
        if self.mesh is None:
            return self.local
        from cpuperformanceraytracer_tpu_torch.parallel.shard import (
            assemble_rows,
        )

        return assemble_rows(self.local, self.cfg, self.mesh)

    @accum.setter
    def accum(self, full: torch.Tensor) -> None:
        row0, h = self.rows
        self.local = full[:, row0:row0 + h].contiguous()

    @property
    def state(self) -> RenderState:
        """The whole accumulator (a collective under a mesh) and the
        frame index."""
        return RenderState(self.accum, self.frame)

    @state.setter
    def state(self, state: RenderState) -> None:
        self.accum, self.frame = state.accum, state.frame

    def _writes(self) -> bool:
        """True on the rank that writes files (rank 0 under a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def resume(self, checkpoint_path: Optional[str]) -> None:
        """Continue from a checkpoint whose image fingerprint matches this
        config; otherwise start fresh (zeros, frame 0)."""
        self.accum, self.frame = resume_or_fresh(checkpoint_path, self.cfg,
                                                 self.device)

    def sync(self) -> None:
        """Wait for the device work enqueued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        """One progressive frame (the accumulator updates in place); with
        tracing on, the span ``driver.frame``."""
        with profiling.span("driver.frame"):
            self.frame_fn(self.texture, self.frame, self.local)
        self.frame += 1

    def step_k(self, k: int) -> None:
        """``k`` progressive frames."""
        for _ in range(k):
            self.step()

    def warmup(self) -> None:
        """``cfg.warmup_frames`` frames into a scratch accumulator, so the
        image equals an unwarmed run's."""
        if self.cfg.warmup_frames <= 0:
            return
        keep = (self.local, self.frame)
        self.local, self.frame = self._zero_rows(), 0
        for _ in range(self.cfg.warmup_frames):
            self.step()
        self.sync()
        self.local, self.frame = keep

    def run(self, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0) -> FrameTimer:
        """Warmup, then the timed loop of ``cfg.num_frames`` frames,
        saving a checkpoint after every ``checkpoint_every``-th frame of
        the loop when ``checkpoint_path`` is given (outside the timed
        spans; the timer's ``checkpoint_s`` holds the seconds they took)."""
        cfg = self.cfg
        self.warmup()
        save_every = checkpoint_every if checkpoint_path else 0
        timer = FrameTimer()
        done = 0
        while done < cfg.num_frames:
            todo = min(SYNC_EVERY, cfg.num_frames - done)
            if save_every:
                todo = min(todo, save_every - done % save_every)
            t0 = time.perf_counter()
            for _ in range(todo):
                self.step()
            self.sync()
            timer.add_span(time.perf_counter() - t0, todo)
            done += todo
            progress(self.log, done - 1, cfg.num_frames)
            if save_every and done % save_every == 0:
                t0 = time.perf_counter()
                accum = self.accum
                if self._writes():
                    save_checkpoint(checkpoint_path, accum, self.frame, cfg)
                timer.checkpoint_s += time.perf_counter() - t0
        rays = cfg.width * cfg.height * cfg.spp
        self.log.info("mean %.3f ms/frame, %.1f Mrays/s (primary)",
                      timer.mean_ms, timer.rays_per_second(rays) / 1e6)
        return timer

    def image_u8(self) -> np.ndarray:
        return postprocess_image(self.accum, self.cfg.exposure,
                                 self.cfg.backend).cpu().numpy()

    def write_image(self, path: str) -> None:
        img = self.image_u8()
        if not self._writes():
            return
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
