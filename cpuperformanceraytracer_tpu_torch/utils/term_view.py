"""Terminal live preview: ANSI truecolor rendering of the progressive
frame + a per-frame stats line.

A copy of ``cpuperformanceraytracer_tpu.utils.term_view`` (numpy only).
The stand-in for the reference's interactive window: the
StretchDIBits present becomes half-block truecolor cells (two image rows
per character via '▀' with independent fg/bg colors), and the title-bar
frame/render-time readout (Application.cpp:308-335) becomes a stats
line below the image. Used by `cli watch --live`.
"""

from __future__ import annotations

import numpy as np

_RESET = "\x1b[0m"
_HOME = "\x1b[H"
_CLEAR = "\x1b[2J"


def _pool(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Mean-pool an (H, W, 3) u8 image to (out_h, out_w, 3) u8.

    Bins are clamped to width >= 1 so UPSAMPLING (out dims larger than
    the image) repeats source pixels instead of producing 0/0 NaN cells."""
    h, w = img.shape[:2]
    ys = np.arange(out_h + 1) * h // out_h
    xs = np.arange(out_w + 1) * w // out_w
    acc = img.astype(np.float32).cumsum(0).cumsum(1)
    z = np.zeros((1, acc.shape[1], 3), np.float32)
    acc = np.concatenate([z, acc], axis=0)
    z = np.zeros((acc.shape[0], 1, 3), np.float32)
    acc = np.concatenate([z, acc], axis=1)
    # per-bin edges clamped to width >= 1 (bins may overlap when
    # upsampling — the cell then repeats the source pixel)
    y0 = ys[:-1].clip(0, h - 1)
    y1 = np.maximum(ys[1:].clip(1, h), y0 + 1)
    x0 = xs[:-1].clip(0, w - 1)
    x1 = np.maximum(xs[1:].clip(1, w), x0 + 1)
    s = (acc[y1[:, None], x1[None, :]] - acc[y0[:, None], x1[None, :]]
         - acc[y1[:, None], x0[None, :]] + acc[y0[:, None], x0[None, :]])
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.float32)
    return (s / area[..., None]).clip(0, 255).astype(np.uint8)


def ansi_frame(img: np.ndarray, cols: int = 96, rows: int = 28) -> str:
    """(H, W, 3) u8 -> ANSI truecolor half-block rendering.

    ``rows`` is in character cells; each cell shows two image rows
    ('▀' foreground = top row, background = bottom row).
    """
    small = _pool(np.asarray(img), rows * 2, cols)
    lines = []
    for y in range(rows):
        top, bot = small[2 * y], small[2 * y + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + _RESET)
    return "\n".join(lines)


def live_view(img: np.ndarray, stats: str, cols: int = 96, rows: int = 28,
              first: bool = False) -> str:
    """Full redraw string: home the cursor, image, stats line."""
    prefix = _CLEAR + _HOME if first else _HOME
    return f"{prefix}{ansi_frame(img, cols, rows)}\n{stats}\x1b[K"
