"""The port's tracing: spans, step-phase events, lane counters and kernel
launch counts, and ``trace(log_dir)``, the operator's entry point.

Tracing is off by default; ``enable()`` and ``disable()`` switch it for
the process (``enabled()`` reads it). When it is off, ``span`` and the
phases of a ``phases`` chain return one shared null context and
``lane_counter`` returns None, so the hot path pays a flag check. When
it is on:

- ``span(name)`` is ``torch.profiler.record_function(name)`` while a
  profiler runs (without one it would cost some 10 us and land nowhere):
  a host span in the profiler's timeline, on the same clock as the
  device operations, nested by time. The port's spans: ``driver.frame``
  (``render/driver.OfflineRenderer.step``); ``frame.render`` (kernel A's
  launch, or each of a frame's launches) and ``frame.resolve`` (kernel
  B, or each E and the F of a frame; ``render/frame.py``); ``dispatch``
  with its children ``dispatch.replay`` (the frame's ``fill_`` and the
  graph's replay) and ``dispatch.losses`` (their copy)
  (``diff/inverse.make_train_step_k`` on the card); ``checkpoint.save``
  with its children ``checkpoint.copy`` (the accumulator to the host),
  ``checkpoint.deflate`` (the members' chunks on the pool) and
  ``checkpoint.write`` (the zip's records, the move into place)
  (``io/checkpoint.save_checkpoint``).
- ``phases(device)`` is the chain of one step's phases, back to back
  (``diff/inverse.make_train_step``: ``step.render``, ``step.loss``,
  ``step.backward``, ``step.adam``). Each phase is a span and, on a CUDA
  device, one timing event is recorded at each boundary: n + 1 events
  for n phases. The events are external, so a stream under capture
  records them as event nodes of the graph.
- ``lane_counter(kernel, device)`` is a persistent, zeroed (2,) int64
  tensor for that kernel on that card, to which the kernel adds the
  lanes that ran and the lane slots of its warp iterations (``kernel_a``,
  ``kernels/megakernel.render_planes``; ``kernel_c``,
  ``kernels/backward.bwd_tables``).

``read()`` gives ``{"lanes": {kernel: (live, slots)}, "phases_ms":
{phase: mean device ms a step}}`` (it waits for the device);
``reset()`` zeroes the counters in place, so that pointers captured
into a graph stay valid, and forgets the phases timed so far.

Under a CUDA graph the flag is read at capture. A graph captured with
tracing on records its phase events and counts lanes at every replay,
whatever the flag is then; one captured with tracing off holds neither.
A graph captured inside ``capturing()`` (``diff/graph.StepGraph``) owns
the phase events its capture recorded; each replay records them anew,
so its phase times are those of its last replay (read once it has been
replayed since ``reset()``). Events recorded in any other capture are
kept for the life of the process and not read.

Launch counts are kept whatever the flag. A kernel wrapper counts the
launches it makes in ``<wrapper>.launches``; kernels A-D, which a CUDA
graph can capture, count through ``count_launch``, which puts a launch
made while the stream is capturing into the capture's tally instead. A
graph captured inside ``capturing()`` keeps that tally and counts its
replays; ``replayed_launches()`` gives the launches its replays made,
apart from the wrappers' own counts: the tally times the replays, taken
from the capture and not counted on the device.

The state is the process's: one tracing switch for all callers, as a
profiler is one for the process.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import weakref

import torch

TRACE_FILE = "trace.json"
COUNTERS_FILE = "counters.json"

_NULL = contextlib.nullcontext()
_on = False
# (kernel, device) -> the kernel's (2,) int64 lane counter on that card
_lanes = {}
# (phase, start event, end event) recorded outside any capture since reset()
_timed = []
# the same, recorded under a capture that no ``capturing()`` block took
_unowned = []
# the live captures made inside ``capturing()``
_captures = weakref.WeakSet()
# wrapper -> the launches it made while a stream was capturing
_captured = collections.Counter()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A host span named ``name`` while tracing is on and a profiler
    runs, else the shared null context."""
    if _on and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


class Phases:
    """One step's phases on one device, entered back to back; a phase's
    end event is the next one's start."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.mark = None

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            if self.cuda and self.mark is None:
                self.mark = _event()
            yield
            if self.cuda:
                end = _event()
                rec = (name, self.mark, end)
                if torch.cuda.is_current_stream_capturing():
                    _unowned.append(rec)
                else:
                    _timed.append(rec)
                self.mark = end


class _NoPhases:
    def phase(self, name: str):
        return _NULL


_NO_PHASES = _NoPhases()


def phases(device):
    """The chain of one step's phases on ``device`` while tracing is on,
    else a shared chain whose phases are the null context."""
    return Phases(device) if _on else _NO_PHASES


def lane_counter(kernel: str, device):
    """The (2,) int64 lane counter of ``kernel`` on the CUDA ``device``
    while tracing is on, else None. It is made, zeroed, at its first
    request outside a capture; a request under a capture before then
    gets None (a capture cannot make it without also zeroing it at every
    replay)."""
    if not _on:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    key = (kernel, device)
    counter = _lanes.get(key)
    if counter is None and not torch.cuda.is_current_stream_capturing():
        counter = _lanes[key] = torch.zeros(2, dtype=torch.int64,
                                            device=device)
    return counter


def count_launch(wrapper) -> None:
    """Count one launch of a kernel wrapper: in ``wrapper.launches``, or,
    while the current stream is capturing, in the capture's tally."""
    if torch.cuda.is_current_stream_capturing():
        _captured[wrapper] += 1
    else:
        wrapper.launches += 1


class Capture:
    """What one CUDA graph's capture made: ``launches``, {wrapper:
    launches}, and ``phases``, its phase events; ``replays`` counts the
    graph's replays, and ``replayed`` is true once it has been replayed
    since ``reset()``."""

    def __init__(self):
        self.launches, self.phases = {}, []
        self.replays, self.replayed = 0, False


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture: yields the graph's ``Capture``,
    filled when the block ends. Its owner keeps it as long as the graph
    and calls ``replayed`` after each replay."""
    made = Capture()
    before, n = collections.Counter(_captured), len(_unowned)
    yield made
    made.launches = dict(_captured - before)
    made.phases = _unowned[n:]
    del _unowned[n:]
    _captures.add(made)


def replayed(made: Capture) -> None:
    """Count one replay of a captured graph (its phase events are then
    the ones ``read()`` times)."""
    made.replays += 1
    made.replayed = True


def replayed_launches() -> dict:
    """{wrapper name: launches} made by the replays of the live graphs
    captured inside ``capturing()``: each capture's tally times its
    replays."""
    out = collections.Counter()
    for made in list(_captures):
        for wrapper, n in made.launches.items():
            out[wrapper.__name__] += n * made.replays
    return dict(out)


def reset() -> None:
    """Zero the lane counters in place and forget the phases timed."""
    for counter in _lanes.values():
        counter.zero_()
    _timed.clear()
    for made in _captures:
        made.replayed = False


def read() -> dict:
    """``{"lanes": {kernel: (live, slots)}, "phases_ms": {phase: mean
    device ms}}`` since ``reset()``: lanes summed over the cards (a
    kernel that ran no lane is left out), each phase's mean over the
    steps timed outside a graph and the steps of each graph's last
    replay."""
    lanes = {}
    for (kernel, _), counter in _lanes.items():
        live, slots = counter.tolist()
        if slots:
            a, b = lanes.get(kernel, (0, 0))
            lanes[kernel] = (a + live, b + slots)
    times = collections.defaultdict(list)
    records = list(_timed) + [rec for made in list(_captures)
                              if made.replayed for rec in made.phases]
    for name, start, end in records:
        end.synchronize()
        times[name].append(start.elapsed_time(end))
    return {"lanes": lanes,
            "phases_ms": {name: sum(t) / len(t) for name, t in times.items()}}


@contextlib.contextmanager
def trace(log_dir: str = "build/cprt_trace"):
    """Profile the enclosed block with tracing on (from a ``reset()``);
    yields ``log_dir``. On exit ``<log_dir>/trace.json`` is the Chrome
    trace (open it in chrome://tracing or Perfetto), in which the port's
    spans and each CUDA kernel the block launched appear by name, and
    ``<log_dir>/counters.json`` the block's ``read()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    enable()
    reset()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        counters = read()
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    with open(os.path.join(log_dir, COUNTERS_FILE), "w") as f:
        json.dump(counters, f, indent=1)
