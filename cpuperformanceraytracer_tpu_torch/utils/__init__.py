"""Timers, logging, terminal view, profiling and debug overlays: the
names ``cpuperformanceraytracer_tpu.utils`` exports."""

from cpuperformanceraytracer_tpu_torch.utils.timing import Timer, FrameTimer  # noqa: F401
from cpuperformanceraytracer_tpu_torch.utils.log import get_logger, progress  # noqa: F401
