"""Debug visualisations: shard and work-unit ownership overlays.

Counterpart of ``cpuperformanceraytracer_tpu.utils.debug_vis`` (the
reference's VISUALIZE_TILES aid, which coloured pixels by worker thread
to check the scheduler). ``shard_ownership_image`` colours each
px-shard's rows (``parallel/shard.py``) and ``overlay`` blends a map over
a render, both as the JAX package does. ``block_ownership_image``
colours the unit of work that the port's kernel A hands out in place of
a Pallas block: a chunk of 32 consecutive pixels of the row-major image
(``csrc/megakernel.cu``: a warp takes a chunk at a time from a counter),
with the JAX package's checker offset so that neighbouring chunks
differ.
"""

from __future__ import annotations

import numpy as np

# pixels a warp of kernel A takes at a time (csrc/megakernel.cu)
CHUNK = 32

_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
], np.uint8)


def shard_ownership_image(cfg, n_px_shards: int) -> np.ndarray:
    """(H, W, 3) u8: each px-shard's row block in a distinct colour."""
    rows_per = cfg.height // n_px_shards
    img = np.zeros((cfg.height, cfg.width, 3), np.uint8)
    for s in range(n_px_shards):
        img[s * rows_per:(s + 1) * rows_per] = _PALETTE[s % len(_PALETTE)]
    return img


def block_ownership_image(cfg) -> np.ndarray:
    """(H, W, 3) u8: each chunk of 32 consecutive pixels coloured by the
    row of its first pixel and its place in that row (bi * 7 + bj * 3,
    the JAX package's checker offset)."""
    chunk = np.arange(cfg.height * cfg.width) // CHUNK
    bi, first = np.divmod(chunk * CHUNK, cfg.width)
    bj = first // CHUNK
    colour = _PALETTE[(bi * 7 + bj * 3) % len(_PALETTE)]
    return colour.reshape(cfg.height, cfg.width, 3)


def overlay(render_u8: np.ndarray, ownership: np.ndarray,
            alpha: float = 0.35) -> np.ndarray:
    """Blend an ownership map over a rendered image."""
    out = (render_u8.astype(np.float32) * (1 - alpha)
           + ownership.astype(np.float32) * alpha)
    return np.clip(out, 0, 255).astype(np.uint8)
