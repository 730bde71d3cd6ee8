"""The ``checkpointed`` traffic kind: a long offline render that can be
resumed. ``OfflineRenderer.step()`` frame after frame into one
accumulator from frame 0, as the ``progressive`` kind renders, and the
call that completes every ``save_every``-th frame also saves a
checkpoint through the program's own save (``port.Progressive.save``)
to a file of its own, named by its frame, under
``build/benchmark/saves/<cell>/``.

The window holds at least ``min_saves`` whole intervals (``pending``)
and ends only once every save it started is whole on disk (``drain``,
which waits up to ``save_wait_s``), so its seconds include every save.
Right after each save's frame a stream-ordered clone of the accumulator
is taken; then the host waits for the device, as the program's own
``OfflineRenderer.run`` waits before it saves, and the save is timed
(``save_ms``).

Its own inputs are the checked frames, drawn from the seed among the
frames of the first ``min_saves`` intervals, so every seed's window
holds the same number of intervals. Checked after the window: the
accumulator at frame 0 and at the checked frames, as the progressive
kind checks it (``pixels_off``), and every save (``saves_off``: the
share of saves whose file, read back with ``numpy.load``, is missing,
unreadable, or not a bit-exact copy of its clone with the frame and the
format version the program was at; ``check.save_fault``). The files are
removed after the check. In a world of several ranks every rank saves
(the program's save is a collective) and rank 0 writes the files; each
rank keeps its rows of each save's clone, and the check compares a save
with the whole clone assembled from every rank's rows.
"""

from __future__ import annotations

import json
import shutil
import time
import zipfile

import numpy as np
import torch

from benchmark.harness import check, spec, window
from benchmark.harness.spec import load_module
from benchmark.reference.tracer import (
    accumulate,
    frame_blend,
    frame_color,
    tables,
)

progressive = load_module("kinds", "progressive")
launches = progressive.launches

# the numbers the cell's checks limit
COMPARES = ("pixels_off", "saves_off")

# the control's save and its planted faults (``save_variants``)
SAVE_VARIANTS = ("sound", "stale", "wrong_frame", "missing", "control")


def draw(cell, gen: torch.Generator, device, scene: dict,
         tex: torch.Tensor) -> dict:
    """The checked frames: ``frames_sampled`` frames of the first
    ``min_saves`` intervals, frame 0 left out (it is always checked);
    none is placed by the window's time, as the progressive kind places
    its own."""
    t = cell.traffic
    n = int(cell.checks["frames_sampled"])
    last = t["min_saves"] * t["save_every"]
    frames = torch.randint(1, last, (n,), generator=gen, device=device)
    return {"check_frames": sorted(int(f) for f in frames.tolist()),
            "check_fractions": [], "check_offsets": []}


def save_dir(cell):
    """The directory of the cell's saves, in the checkout's ``build``."""
    return spec.ROOT / "build" / "benchmark" / "saves" / cell.name


def whole(path) -> bool:
    """True where ``path`` is a whole zip archive (its central directory,
    written last, reads)."""
    try:
        with zipfile.ZipFile(path):
            return True
    except (OSError, zipfile.BadZipFile):
        return False


class Session(progressive.Session):
    """The progressive session with a save every ``save_every`` frames;
    ``saves`` holds (path, frame, accumulator clone, host ms of the
    save call) of each."""

    def __init__(self, inputs, cell, seconds: float, device, mesh=None):
        super().__init__(inputs, cell, seconds, device, mesh)
        t = cell.traffic
        self.every, self.min_saves = t["save_every"], t["min_saves"]
        self.wait_s = t["save_wait_s"]
        self._planned.update(inputs.check_frames)
        self.dir = save_dir(cell)
        self.writes = self.program.writes
        if self.writes:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir.mkdir(parents=True)
        self.device = device
        self.frames = 0
        self.saves = []
        self.in_window = 0
        self.call = self._call

    def _call(self) -> None:
        self.program.call()
        self.frames += 1
        if self.frames % self.every:
            return
        want = self.program.accum.clone()
        path = self.dir / f"frame_{self.frames:08d}.npz"
        # the frames first, as ``OfflineRenderer.run`` waits for them
        # before it saves: the save's time is the save's alone
        window.sync(self.device)
        t0 = time.perf_counter()
        self.program.save(str(path))
        ms = (time.perf_counter() - t0) * 1e3
        self.saves.append((path, self.frames, want, ms))

    def pending(self) -> bool:
        return super().pending() or len(self.saves) < self.min_saves

    def drain(self) -> None:
        """Wait until every save of the window is whole on disk (on the
        rank that writes them)."""
        self.in_window = len(self.saves)
        deadline = time.perf_counter() + self.wait_s
        for path, *_ in (self.saves if self.writes else ()):
            while not whole(path) and time.perf_counter() < deadline:
                time.sleep(0.001)

    def rows(self) -> dict:
        """The snapshots' rows and this rank's rows of each save's clone."""
        return {**super().rows(), "saves": [want for _, _, want, _ in
                                            self.saves]}

    def take_rows(self, whole: dict) -> None:
        super().take_rows(whole)
        self.saves = [(path, frame, want, ms) for (path, frame, _, ms), want
                      in zip(self.saves, whole["saves"])]

    def check(self, inputs, cell, log):
        """The progressive check's numbers and counts, with ``saves_off``
        and, in the counts, ``save_ms``: the mean host ms of the
        window's save calls."""
        got, counts = super().check(inputs, cell, log)
        version = cell.checks["format_version"]
        faults = {}
        for path, frame, want, _ in self.saves:
            fault = check.save_fault(path, want, frame, version, inputs.opts)
            if fault is not None:
                faults[frame] = fault
        window_ms = [ms for *_, ms in self.saves[:self.in_window]]
        written = sum(p.stat().st_size for p, *_ in self.saves if p.exists())
        log(f"saves: {len(self.saves)} ({self.in_window} in the window), "
            f"host ms {[round(ms, 3) for *_, ms in self.saves]}, "
            f"{written} bytes; off: {faults or 'none'}")
        got["saves_off"] = (len(faults) / len(self.saves) if self.saves
                            else 1.0)
        if window_ms:
            counts["save_ms"] = sum(window_ms) / len(window_ms)
        self.saves = []
        shutil.rmtree(self.dir, ignore_errors=True)
        return got, counts


def reference_save(path, accum: torch.Tensor, frame: int, opts: dict,
                   version: int) -> None:
    """The checkpoint format written plainly with numpy: the control's
    save, put in the program's place."""
    planes = accum.cpu().numpy()
    with open(path, "wb") as f:
        np.savez_compressed(f, version=version, frame=int(frame),
                            r=planes[0], g=planes[1], b=planes[2],
                            config=json.dumps(opts))


def save_variants(inputs, cell) -> dict:
    """{variant: saves_off} of one save of the accumulator after frame 1
    (two frames) at the cell's size, written by ``reference_save``:
    ``sound``; and planted: ``stale`` (the accumulator of the interval
    before, after frame 0, under the new frame), ``wrong_frame`` (the
    frame index off by one), ``missing`` (no file) and ``control`` (the
    accumulator rounded to bfloat16 before the save)."""
    opts = inputs.opts
    version = cell.checks["format_version"]
    tabs = tables(inputs.scene, opts)
    accs = []
    acc = None
    for frame in (0, 1):
        with torch.no_grad():
            color = frame_color(tabs, inputs.tex, inputs.tex_w, inputs.tex_h,
                                opts, frame)
        acc = accumulate(torch.zeros_like(color) if acc is None else acc,
                         color, frame_blend(frame))
        accs.append(acc)
        del color
    d = save_dir(cell) / "control"
    out = {}
    for variant in SAVE_VARIANTS:
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        path, frame, want = d / "frame_00000002.npz", 2, accs[1]
        if variant == "sound":
            reference_save(path, want, frame, opts, version)
        elif variant == "stale":
            reference_save(path, accs[0], frame, opts, version)
        elif variant == "wrong_frame":
            reference_save(path, want, frame + 1, opts, version)
        elif variant == "control":
            reference_save(path, want.to(torch.bfloat16).float(), frame,
                           opts, version)
        out[variant] = float(check.save_fault(path, want, frame, version,
                                              opts) is not None)
    shutil.rmtree(d.parent, ignore_errors=True)
    return out


def control(inputs, cell, look: bool = False) -> dict:
    """{variant: {number: reading}}: the progressive kind's control and
    faults over frame 0 and the seed's checked frames (``pixels_off``),
    and the saves' (``saves_off``)."""
    frames = [0] + list(inputs.check_frames)
    got = {k: {"pixels_off": v} for k, v in
           progressive.variants(inputs, cell.checks, frames).items()}
    for k, v in save_variants(inputs, cell).items():
        got.setdefault(k, {})["saves_off"] = v
    return got
