"""The measured window, and the device time of a call with the stream
held full.

The window is a closed loop: one client enqueues calls back to back in
chunks, and before it enqueues a chunk past ``in_flight`` it waits for
the end of the oldest chunk still running, so the host stays at most
that many chunks ahead of the device and never waits for an empty
stream. The window starts at the first call and ends when the device
has finished the last call enqueued after ``seconds`` had passed: its
length covers all the work it counts. An event recorded after every call
gives each call's time on the device's clock.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time

import torch


@dataclasses.dataclass
class Window:
    calls: int
    seconds: float            # host clock, first enqueue to the last sync
    call_ms: list             # device time of each call (CUDA events)

    @property
    def ms_per_call(self) -> float:
        return self.seconds * 1e3 / self.calls


class Session:
    """What a traffic kind (``benchmark/kinds/<kind>.py``) hands the
    window: ``call()`` enqueues one call of the program's entry point,
    ``steps_per_call`` counts the steps it makes, and the hooks below,
    which do nothing here, let the kind watch the window (``before(n)``
    / ``after(n)`` around call n, ``plan(n, elapsed)`` before each
    chunk, whose first call is n; while ``pending()`` is true the window
    goes on past its seconds; ``drain()`` waits, inside the window, for
    what the calls started on the host, such as files being written).
    After the window ``release()`` frees the program's state, and
    ``check(inputs, cell, log)`` compares what the calls produced with
    the reference."""

    steps_per_call = 1

    def before(self, n: int) -> None:
        pass

    def after(self, n: int) -> None:
        pass

    def plan(self, n: int, elapsed: float) -> None:
        pass

    def pending(self) -> bool:
        return False

    def drain(self) -> None:
        pass


class Clock:
    """CUDA events on the current stream."""

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        mark.synchronize()

    def sync(self) -> None:
        torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Chunks:
    """The window's calls, a chunk at a time, as every rank of a world
    makes them (``run_window`` here, a follower's ``on_chunk`` in
    ``harness/world.py``): ``run(n, elapsed)`` hands ``session`` its
    ``plan`` and makes the chunk's calls from call n, each between its
    hooks and followed by an event, then waits, past ``in_flight``
    chunks, for the end of the oldest still running; ``drain()`` ends
    the window; ``call_ms()`` is the device time of each call, from
    consecutive events. Only the stop rule is the caller's."""

    def __init__(self, session: Session, chunk: int, in_flight: int):
        self.session, self.chunk, self.in_flight = session, chunk, in_flight
        self.clock = Clock()
        self.clock.sync()
        self.ends = collections.deque()
        # no garbage collection in the window: the event kept a call would
        # otherwise set off collections that hold the host up mid-window;
        # the caller enables it again once the window has ended
        gc.collect()
        gc.disable()
        self.t0 = time.perf_counter()
        self.marks = [self.clock.mark()]

    def run(self, n: int, elapsed: float) -> int:
        """The chunk from call ``n``, planned ``elapsed`` seconds into
        the window; returns the number of its next call."""
        s = self.session
        s.plan(n, elapsed)
        for i in range(n, n + self.chunk):
            s.before(i)
            s.call()
            s.after(i)
            self.marks.append(self.clock.mark())
        self.ends.append(self.marks[-1])
        if len(self.ends) >= self.in_flight:
            self.clock.wait(self.ends.popleft())
        return n + self.chunk

    def drain(self) -> None:
        """Wait for what the calls started, and for the device."""
        self.session.drain()
        self.clock.sync()

    def call_ms(self) -> list:
        m = self.marks
        return [self.clock.ms(a, b) for a, b in zip(m, m[1:])]


def run_window(session: Session, seconds: float, chunk: int,
               in_flight: int) -> Window:
    """Enqueue ``session.call()`` in chunks of ``chunk`` until ``seconds``
    have passed, at most ``in_flight`` chunks ahead of the device."""
    chunks = Chunks(session, chunk, in_flight)
    n = 0
    try:
        while True:
            n = chunks.run(n, time.perf_counter() - chunks.t0)
            if (time.perf_counter() - chunks.t0 >= seconds
                    and not session.pending()):
                break
        chunks.drain()
        elapsed = time.perf_counter() - chunks.t0
    finally:
        gc.enable()
    return Window(n, elapsed, chunks.call_ms())


def held_ms(call, n: int, device) -> tuple:
    """(device ms, host enqueue ms) per call over ``n`` calls with the
    stream held full: a sleep kernel holds the stream while the host
    enqueues the calls, so no call waits for the host; CUDA events around
    the calls give their device time and the host clock their enqueue
    time. The sleep is retried longer if the stream drained first (the
    method of the program's ``utils/timing.device_ms``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for margin in (4, 16, 64):
        # cycles at <= 2 GHz, so the sleep outlasts the enqueue
        cycles = int(max(margin * n * host_s, 1e-3) * 2e9)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        h0 = time.perf_counter()
        for _ in range(n):
            call()
        h1 = time.perf_counter()
        end.record()
        drained = start.query()
        torch.cuda.synchronize()
        if not drained:
            return start.elapsed_time(end) / n, (h1 - h0) * 1e3 / n
    raise RuntimeError("held_ms: the stream drained while calls were enqueued")


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
