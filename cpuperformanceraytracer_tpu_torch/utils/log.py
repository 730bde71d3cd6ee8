"""Logging and offline progress reporting.

A copy of ``cpuperformanceraytracer_tpu.utils.log`` (numpy-free, no
jax): the reference's 1% progress prints as standard logging on stderr;
``silent`` raises the level to WARNING.
"""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "cprt_torch", silent: bool = False) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.WARNING if silent else logging.INFO)
    return logger


def progress(logger: logging.Logger, frame: int, total: int) -> None:
    """Log at every whole percent of ``total`` frames (``frame`` 0-based)."""
    if total <= 0:
        return
    step = max(total // 100, 1)
    if frame % step == 0 or frame == total - 1:
        logger.info("render progress: %d%% (%d/%d frames)",
                    int(100 * (frame + 1) / total), frame + 1, total)
