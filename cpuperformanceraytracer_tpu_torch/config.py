"""Render configuration: the knobs of the forward progressive frame.

Field names and defaults follow ``cpuperformanceraytracer_tpu.config``
so a config can be compared field by field with the JAX one. The TPU
block-shape and dispatch knobs (tile_*, exit_granularity, accum_layout,
frames_per_dispatch, bwd_tile_height, env_tex_shape) have no meaning on
a GPU and are not carried over; ``RenderConfig.from_dict`` drops them
when it reads a JAX config (a checkpoint's). ``BENCH_CONFIGS`` are the
JAX package's named presets without those knobs.

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

    # "none" (constant ambient), "equirect" or "cubemap" (six faces
    # stacked vertically, px nx py ny pz nz)
    env_mode: str = "equirect"
    # "stochastic" (jittered 1-tap), "nearest" or "bilinear" (4 taps)
    env_sampling: str = "stochastic"
    ambient: tuple = (0.11, 0.10, 0.15)
    env_flip_xz: bool = True

    unit_vector_sampler: str = "normalized3"   # or "zangle"
    jitter: bool = True
    rng: str = "wang"                          # or "counter"
    roulette: str = "v4_quirk"                 # "off", "terminate", "v4_quirk"
    # progressive accumulation (ACCUMULATE_FRAMES); part of the image
    # fingerprint of a checkpoint, as in the JAX package
    accumulate: bool = True
    exposure: float = 1.0
    # kept for parity with the JAX config; the port's kernel A always
    # ends a dead path where no later draw depends on it (the output is
    # identical either way), so the field changes nothing
    early_exit: bool = True

    backend: str = "cuda"                      # or "torch"

    def validate(self) -> "RenderConfig":
        """Raise ValueError on invalid values."""
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
        return self

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "RenderConfig":
        """A config from a field dict, the JAX package's included: fields
        this port does not have (the TPU knobs) are dropped, and so is a
        backend that is not one of the port's ("xla", "pallas")."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if kw.get("backend") not in (None, "torch", "cuda"):
            del kw["backend"]
        if "ambient" in kw:
            kw["ambient"] = tuple(kw["ambient"])
        return cls(**kw)


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


# The JAX package's named presets (its BASELINE.json configs) without the
# TPU knobs; all run the CUDA kernels.
BENCH_CONFIGS = {
    # demofox scalar scene: 320x240, 1 spp, 2 bounces, no env map
    "scalar_320": RenderConfig(
        width=320, height=240, spp=1, bounces=2, scene="cornell_box",
        env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
        jitter=True, roulette="off", num_frames=512),
    # simd_tiled scene: 1280x720, 8 bounces, 4 spp, no env map
    "simd_tiled_720": RenderConfig(
        width=1280, height=720, spp=4, bounces=8, scene="glass_spheres",
        env_mode="none", num_frames=64),
    # simt_textured scene: 1920x1080 + env map, 16 spp (counter RNG: one
    # kernel A launch and one env lookup per sample, combined once)
    "textured_1080": RenderConfig(
        width=1920, height=1080, spp=16, bounces=8, scene="glass_spheres",
        env_mode="equirect", num_frames=16, rng="counter"),
    # differentiable inverse render (diff/inverse.py)
    "inverse_render": RenderConfig(
        width=160, height=120, spp=4, bounces=3, scene="glass_spheres",
        env_mode="none", rng="counter", num_frames=1),
    # offline high-spp: 3840x2160, 1024 frames of 1 spp accumulated
    # progressively (checkpoint/resume on frame boundaries)
    "offline_4k": RenderConfig(
        width=3840, height=2160, spp=1, bounces=8, scene="glass_spheres",
        env_mode="equirect", rng="counter", num_frames=1024),
    # the reference's default workload
    "reference_default": RenderConfig(),
}
