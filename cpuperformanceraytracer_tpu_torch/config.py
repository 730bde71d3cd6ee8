"""Render configuration: the knobs of the forward progressive frame.

Field names and defaults follow ``cpuperformanceraytracer_tpu.config``
so a config can be compared field by field with the JAX one. The TPU
block-shape and dispatch knobs (tile_*, exit_granularity, accum_layout,
frames_per_dispatch, bwd_tile_height, env_tex_shape) have no meaning on
a GPU and are not carried over.

``backend`` picks the implementation of every kernel: ``"cuda"`` (the
default) runs the hand-written CUDA kernels on the GPU and raises where
there is none; ``"torch"`` is the caller's explicit request for the
plain-torch versions, on the device the caller names (the CPU unless
told otherwise). ``resolve_device`` maps the two to a device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    spp: int = 1
    bounces: int = 8            # the bounce loop runs bounces+1 segments
    num_frames: int = 600
    warmup_frames: int = 2

    scene: str = "glass_spheres"

    # "none" (constant ambient) or "equirect"; "cubemap" is not ported yet
    env_mode: str = "equirect"
    # "stochastic" (jittered 1-tap) or "nearest"; "bilinear" not ported yet
    env_sampling: str = "stochastic"
    ambient: tuple = (0.11, 0.10, 0.15)
    env_flip_xz: bool = True

    unit_vector_sampler: str = "normalized3"   # or "zangle"
    jitter: bool = True
    rng: str = "wang"                          # or "counter"
    roulette: str = "v4_quirk"                 # "off", "terminate", "v4_quirk"
    exposure: float = 1.0
    # per-thread exit of a dead path's remaining segments where no later
    # draw depends on them; the output is identical either way
    early_exit: bool = True

    backend: str = "cuda"                      # or "torch"

    def validate(self) -> "RenderConfig":
        """Raise ValueError on invalid values, NotImplementedError on
        valid JAX-package settings this port does not support yet."""
        errs = []
        if self.width <= 0 or self.height <= 0:
            errs.append(f"resolution {self.width}x{self.height} must be positive")
        if self.spp < 1:
            errs.append("spp must be >= 1")
        if self.bounces < 0:
            errs.append("bounces must be >= 0")
        if self.env_mode not in ("none", "equirect", "cubemap"):
            errs.append(f"env_mode {self.env_mode!r} invalid")
        if self.env_sampling not in ("bilinear", "nearest", "stochastic"):
            errs.append(f"env_sampling {self.env_sampling!r} invalid")
        if self.unit_vector_sampler not in ("normalized3", "zangle"):
            errs.append(f"unit_vector_sampler {self.unit_vector_sampler!r} invalid")
        if self.rng not in ("wang", "counter"):
            errs.append(f"rng {self.rng!r} invalid")
        if self.roulette not in ("off", "terminate", "v4_quirk"):
            errs.append(f"roulette {self.roulette!r} invalid")
        if self.backend not in ("torch", "cuda"):
            errs.append(f"backend {self.backend!r} invalid")
        if errs:
            raise ValueError("invalid RenderConfig: " + "; ".join(errs))
        if self.env_mode == "cubemap":
            raise NotImplementedError(
                "env_mode 'cubemap' is not ported yet: the env kernel "
                "implements the equirect lookup only")
        if self.env_mode != "none" and self.env_sampling == "bilinear":
            raise NotImplementedError(
                "env_sampling 'bilinear' is not ported yet: the deferred "
                "env kernel fetches one texel (stochastic or nearest)")
        return self

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(backend: str, device=None) -> torch.device:
    """The device a backend runs on: ``"cuda"`` needs a CUDA GPU (it never
    falls back to the CPU); ``"torch"`` takes ``device``, the CPU if None."""
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'cuda' needs a CUDA GPU; none is "
                               "available (use backend 'torch' on the CPU)")
        device = torch.device(device if device is not None else "cuda")
        if device.type != "cuda":
            raise ValueError(f"backend 'cuda' needs a cuda device, got {device}")
        return device
    return torch.device(device if device is not None else "cpu")
