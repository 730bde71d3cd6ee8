"""Image writers, checkpoint/resume, the native codec and conversion of
JAX-package state to the port's: the names
``cpuperformanceraytracer_tpu.io`` exports."""

from cpuperformanceraytracer_tpu_torch.io.image import write_bmp, write_png  # noqa: F401
from cpuperformanceraytracer_tpu_torch.io.checkpoint import (  # noqa: F401
    save_checkpoint,
    load_checkpoint,
)
