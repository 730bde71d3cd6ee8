"""Checkpoint / resume of a progressive render.

The JAX package's format (``cpuperformanceraytracer_tpu.io.checkpoint``),
so either package resumes the other's checkpoints: one ``.npz`` with
``version`` 1, ``frame``, the accumulator planes ``r``, ``g``, ``b``
((H, W) f32) and ``config``, the JSON of the config's fields. The port's
fields are a subset of the JAX config's (``accumulate`` included, which
the JAX fingerprint reads), so the JAX loader builds its config from the
port's JSON; the port reads a JAX config through
``RenderConfig.from_dict``, which drops the TPU knobs.

A checkpoint resumes only under a config with the same image
fingerprint (every field that shapes the accumulated image); any other
starts fresh rather than averaging two different renders. The file is
written to a temporary name and moved into place, so a preempted save
leaves the previous checkpoint whole.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.config import RenderConfig

FORMAT_VERSION = 1

# the JAX package's _IMAGE_FIELDS
IMAGE_FIELDS = (
    "width", "height", "spp", "bounces", "scene", "env_mode",
    "env_sampling", "ambient", "env_flip_xz", "unit_vector_sampler",
    "jitter", "rng", "roulette", "accumulate",
)


def image_fingerprint(cfg) -> tuple:
    """The image-content identity of a config (either package's): equal
    fingerprints accumulate identical progressive frames."""
    return tuple(
        (f, tuple(v) if isinstance(v, (list, tuple)) else v)
        for f, v in ((f, getattr(cfg, f)) for f in IMAGE_FIELDS))


def save_checkpoint(path: str, accum: torch.Tensor, frame: int,
                    cfg: RenderConfig) -> None:
    """Write the (3, H, W) accumulator, the frame index and the config."""
    planes = accum.detach().cpu().numpy()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, version=FORMAT_VERSION, frame=int(frame), r=planes[0],
            g=planes[1], b=planes[2],
            config=json.dumps(dataclasses.asdict(cfg)))
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[np.ndarray, int, RenderConfig]:
    """(accumulator (3, H, W) f32, frame, config) of a checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        cfg = RenderConfig.from_dict(json.loads(str(z["config"])))
        accum = np.stack([z["r"], z["g"], z["b"]]).astype(np.float32)
        return accum, int(z["frame"]), cfg


def resume_or_fresh(path: Optional[str], cfg: RenderConfig,
                    device="cpu") -> Tuple[torch.Tensor, int]:
    """(accumulator on ``device``, start frame): the checkpoint's when it
    exists and its fingerprint equals ``cfg``'s, else zeros and 0."""
    if path and os.path.exists(path):
        accum, frame, saved = load_checkpoint(path)
        if image_fingerprint(saved) == image_fingerprint(cfg):
            return torch.as_tensor(accum, device=device).contiguous(), frame
    return torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32,
                       device=device), 0
