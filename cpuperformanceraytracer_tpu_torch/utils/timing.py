"""Frame timer for the offline protocol: warmup, then timed spans.

Counterpart of ``cpuperformanceraytracer_tpu.utils.timing.FrameTimer``.
A span is (seconds, frames): frames are enqueued back to back and one
device synchronise closes the span, so the wall time covers the device
work. Means and rates come from span totals.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class FrameTimer:
    warmup_frames: int = 0
    _spans: List[tuple] = field(default_factory=list)
    _seen: int = 0

    def add_span(self, seconds: float, frames: int) -> None:
        """Record ``frames`` frames timed together; frames still inside
        the warmup count are dropped, with a prorated share of time."""
        self._seen += frames
        timed = min(frames, self._seen - self.warmup_frames)
        if timed >= frames:
            self._spans.append((seconds, frames))
        elif timed > 0:
            self._spans.append((seconds * timed / frames, timed))

    @property
    def spans(self) -> List[tuple]:
        return list(self._spans)

    @property
    def timed_frames(self) -> int:
        return sum(n for _, n in self._spans)

    @property
    def mean_ms(self) -> float:
        n = self.timed_frames
        return 1e3 * sum(s for s, _ in self._spans) / n if n else float("nan")

    def rays_per_second(self, rays_per_frame: float) -> float:
        total = sum(s for s, _ in self._spans)
        if not total:
            return float("nan")
        return rays_per_frame * self.timed_frames / total
