"""The progressive frame step and the display transform.

Counterpart of ``cpuperformanceraytracer_tpu.render.frame`` and the JAX
multi-sample logic (``megakernel.py`` ``render_frame_pallas``,
``render_accumulate_pallas``, ``_env_combined``). The accumulator is one
planar (3, H, W) f32 tensor, updated IN PLACE by each step: the
counterpart of the JAX step's donated buffer. Two routes:

- A -> B (the forward main path): no env map, or one sample per frame
  of the stochastic or nearest equirect lookup. Kernel A renders the
  frame's samples, kernel B resolves the env and accumulates.
- A -> E -> F (the textured multi-sample frame): an env map with spp >
  1, bilinear or cubemap. Kernel A renders each sample into its slot of
  one (spp, 12, H, W) buffer on an addressable counter stream
  (``sample0 = s``), kernel E looks the env up into slot s of one
  (spp, P, 4) buffer, and kernel F combines all samples and accumulates
  once per frame. The lookup is the real one of every mode: bilinear
  takes four taps at every spp (the JAX fused step takes the nearest tap
  for bilinear when spp > 1; the port does not copy that).

The sequential wang stream cannot split into per-sample launches, so
spp > 1 with an env map needs the counter RNG on both kernel routes, as
in JAX. The third route, ``backend="oracle"``, renders the frame with
the oracle integrator (``render/integrator.render_frame``, the JAX
``"xla"`` route) and accumulates it; it takes every config, the wang RNG
with spp > 1 and an env map included.

Image convention: (H, W), row 0 = top; the fragCoord y of a row is
H-1-row.
"""

from __future__ import annotations

import numpy as np
import torch

from cpuperformanceraytracer_tpu_torch.core.color import to_u8
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.kernels.combine import (
    combine_accumulate,
    combine_accumulate_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_accumulate import (
    env_accumulate,
    env_accumulate_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.env_gather import (
    env_lookup,
    env_lookup_reference,
)
from cpuperformanceraytracer_tpu_torch.kernels.megakernel import (
    N_PLANES,
    pack_tables,
    render_planes,
    render_planes_reference,
    window,
)
from cpuperformanceraytracer_tpu_torch.kernels.tonemap import (
    tonemap,
    tonemap_reference,
)
from cpuperformanceraytracer_tpu_torch.render.integrator import (
    render_frame,
    to_device,
)


def frame_blend(frame: int) -> float:
    """1 / (f32(frame) + 1) in f32: frame 0 stores its color exactly."""
    return float(np.float32(1.0) / (np.float32(frame) + np.float32(1.0)))


def zero_accum(cfg, device="cpu") -> torch.Tensor:
    return torch.zeros((3, cfg.height, cfg.width), dtype=torch.float32,
                       device=device)


def postprocess_image(accum, exposure: float = 1.0,
                      backend: str = "cuda") -> torch.Tensor:
    """(3, H, W) f32 -> (H, W, 3) u8: kernel G's display transform
    (exposure, ACES, sRGB; its plain version for backend "torch"), then
    the round to u8."""
    display = (tonemap if backend == "cuda" else tonemap_reference)(
        accum, exposure)
    return to_u8(Vec3(*display))


def uses_combine(cfg) -> bool:
    """True when a frame takes the A -> E -> F route."""
    return cfg.env_mode != "none" and (
        cfg.spp > 1 or cfg.env_mode == "cubemap"
        or cfg.env_sampling == "bilinear")


def _render_plain(tables, cfg, frame, sample0=0, out=None, **rows):
    return out.copy_(render_planes_reference(tables, cfg, frame, sample0,
                                             **rows))


def accumulate_frame(accum, color, blend: float) -> torch.Tensor:
    """``accum += (color - accum) * blend`` in place, channel by channel
    (the JAX ``accumulate_frame``; kernels B and F do the same in f32)."""
    for c in range(3):
        accum[c] += (color[c] - accum[c]) * blend
    return accum


def make_frame_fn(cfg, scene, camera, device, row0: int = 0,
                  local_height=None, spp_offset: int = 0):
    """Build ``step(texture, frame, accum, blend=None) -> accum``: one
    progressive frame of ``cfg.spp`` samples, accumulated into ``accum``
    in place with ``blend`` (``frame_blend(frame)`` by default; blend 1
    into a zeroed buffer gives the frame's colour exactly).

    ``cfg.backend`` picks the kernels ("cuda"), their plain-torch
    versions ("torch") or the oracle integrator ("oracle"); the scene is
    packed into the kernel tables on ``device`` once, here (the oracle
    takes the scene and camera as they are, moved to ``device``).
    ``row0``/``local_height`` pick a window of pixel rows (``accum`` is
    then (3, local_height, W)) and ``spp_offset`` the first sample: the
    sharding hooks of ``parallel/shard.py``, the whole image from sample
    0 by default."""
    cfg = cfg.validate()
    row0, h = window(cfg, row0, local_height)
    rows = dict(row0=row0, local_height=h)
    if cfg.backend == "oracle":
        scene, camera = to_device((scene, camera), device)

        def step(texture, frame: int, accum: torch.Tensor,
                 blend=None) -> torch.Tensor:
            color = render_frame(scene, camera, texture, cfg, frame,
                                 spp_offset=spp_offset, **rows)
            return accumulate_frame(
                accum, color, frame_blend(frame) if blend is None else blend)

        return step
    if cfg.spp > 1 and cfg.env_mode != "none" and cfg.rng != "counter":
        raise NotImplementedError(
            "spp > 1 with an env map needs rng='counter' (per-sample "
            "addressable streams); the wang stream is sequential across "
            "the sample loop")
    tables = pack_tables(scene, camera, cfg, device)
    cuda = cfg.backend == "cuda"
    # kernels B, E and F work per pixel: they see the window as an image
    # of its own rows
    local = cfg.replace(height=h)
    if not uses_combine(cfg):
        render = render_planes if cuda else render_planes_reference
        resolve = env_accumulate if cuda else env_accumulate_reference

        def step(texture, frame: int, accum: torch.Tensor,
                 blend=None) -> torch.Tensor:
            planes = render(tables, cfg, frame, sample0=spp_offset, **rows)
            return resolve(planes, texture, local, accum,
                           frame_blend(frame) if blend is None else blend)

        return step

    render = render_planes if cuda else _render_plain
    lookup = env_lookup if cuda else env_lookup_reference
    combine = combine_accumulate if cuda else combine_accumulate_reference
    one = cfg.replace(spp=1)
    spp, w = cfg.spp, cfg.width
    bufs = {}

    def step(texture, frame: int, accum: torch.Tensor,
             blend=None) -> torch.Tensor:
        if not bufs:
            kw = dict(dtype=torch.float32, device=accum.device)
            bufs["planes"] = torch.empty((spp, N_PLANES, h, w), **kw)
            bufs["e4"] = torch.empty((spp, h * w, 4), **kw)
        planes, e4 = bufs["planes"], bufs["e4"]
        for s in range(spp):
            render(tables, one, frame, sample0=spp_offset + s, out=planes[s],
                   **rows)
            lookup(planes[s], texture, local, out=e4[s])
        blend = frame_blend(frame) if blend is None else blend
        if spp == 1:
            return combine(e4[0], planes[0, 0:3], planes[0, 6:9], accum, blend)
        return combine(e4, planes[:, 0:3], planes[:, 6:9], accum, blend)

    return step
