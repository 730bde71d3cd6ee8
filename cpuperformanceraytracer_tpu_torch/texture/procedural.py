"""Procedural environment textures for tests and asset-free demos.

The reference hardcodes absolute E:\\ texture paths
(Application.cpp:199-216); tests there were impossible without the
artist's disk. Here every env-map test can synthesize a deterministic
sky instead of reading assets.
"""

from __future__ import annotations

import numpy as np


def gradient_sky(width: int = 64, height: int = 32, seed: int = 0) -> np.ndarray:
    """A smooth, deterministic (H, W, 3) f32 sky: vertical gradient with a
    horizontal hue rotation and a bright 'sun' blob, values in [0, ~20]."""
    rs = np.random.RandomState(seed)
    v = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    u = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    base = np.stack(
        [
            0.2 + 0.8 * v + 0.1 * np.sin(2 * np.pi * u),
            0.3 + 0.6 * v + 0.1 * np.cos(2 * np.pi * u),
            0.5 + 0.5 * v + 0.0 * u,
        ],
        axis=-1,
    ).astype(np.float32)
    # sun blob
    su, sv = rs.uniform(0.2, 0.8), rs.uniform(0.5, 0.9)
    d2 = (u - su) ** 2 + (v - sv) ** 2
    base += (18.0 * np.exp(-d2 / 0.005))[..., None].astype(np.float32)
    return base
