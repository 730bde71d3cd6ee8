"""The ``progressive`` traffic kind: one viewer's progressive render,
``OfflineRenderer.step()`` frame after frame into one accumulator from
frame 0.

Its own inputs are the checked frames' places in the window, drawn from
the seed. A checked frame's accumulator is kept on either side of it
(frame 0, from the zero accumulator, and frames across the window, from
the program's own accumulator before them); after the window the
reference renders each checked frame, accumulates it into the program's
accumulator from before it, and compares the two accumulators after it
(``check.pixels_off``).
"""

from __future__ import annotations

import torch

from benchmark.harness import check, window
from benchmark.reference.tracer import (
    accumulate,
    frame_blend,
    frame_color,
    tables,
)


def draw(cell, gen: torch.Generator, device, scene: dict,
         tex: torch.Tensor) -> dict:
    """The checked frames: for each, a fraction of the window and an
    offset into the first chunk that starts after it."""
    n = int(cell.checks["frames_sampled"])
    draws = torch.rand(2 * n, generator=gen, device=device).tolist()
    return {"check_fractions": sorted(0.9 * d for d in draws[:n]),
            "check_offsets": [int(d * cell.traffic["calls_per_chunk"])
                              for d in draws[n:]]}


def launches(opts: dict, traffic: dict) -> dict:
    """{work file: launches a frame}: the wang RNG renders a frame's
    samples in one launch of A and resolves them with B; the counter RNG
    with several samples launches A and E once a sample and F once."""
    if opts["rng"] == "counter" and opts["spp"] > 1:
        return {"kernel_a": opts["spp"], "kernel_e": opts["spp"],
                "kernel_f": 1}
    return {"kernel_a": 1 if opts["rng"] == "wang" else opts["spp"],
            "kernel_b": 1}


class Session(window.Session):
    """The program's renderer, warmed, and the snapshots of the checked
    frames taken as the window runs."""

    steps_per_call = 1

    def __init__(self, inputs, cell, seconds: float, device):
        from benchmark.harness import port

        self.program = port.Progressive(inputs, cell.traffic, device)
        self.program.warm()
        self.call = self.program.call
        self.seconds = seconds
        self.snaps, self._pre, self._planned = {}, {}, {0}
        self._todo = list(zip(inputs.check_fractions, inputs.check_offsets))

    def plan(self, n: int, elapsed: float) -> None:
        while self._todo and self._todo[0][0] * self.seconds <= elapsed:
            self._planned.add(n + self._todo.pop(0)[1])

    def before(self, n: int) -> None:
        if n in self._planned:
            self._pre[n] = self.program.accum.clone()

    def after(self, n: int) -> None:
        if n in self._pre:
            self.snaps[n] = (self._pre.pop(n), self.program.accum.clone())

    def pending(self) -> bool:
        return bool(self._todo) or len(self.snaps) < len(self._planned)

    def release(self) -> None:
        self.program = self.call = None

    def check(self, inputs, cell, log):
        """({"pixels_off": worst share, ...}, the reference's live paths
        a launch and texels read a launch)."""
        tabs = tables(inputs.scene, inputs.opts)
        stats, per_frame = {}, {}
        for frame, (pre, post) in sorted(self.snaps.items()):
            with torch.no_grad():
                color = frame_color(tabs, inputs.tex, inputs.tex_w,
                                    inputs.tex_h, inputs.opts, frame, stats)
            per_frame[frame] = check.pixels_off(pre, post, color, frame,
                                                cell.checks["colour_atol"])
            del color
        log("pixels off by frame: " + str(per_frame))
        launches = len(stats["live"]) // (inputs.opts["bounces"] + 1)
        counts = {"live_per_launch": sum(stats["live"]) / max(launches, 1),
                  "texels_per_launch": sum(stats["texels"])
                  / len(stats["texels"])}
        return {"pixels_off": max(per_frame.values())}, counts


def variants(inputs, checks: dict, frames) -> dict:
    """{variant: pixels_off} over ``frames``, each checked from a zero
    accumulator (frame 0's start; the comparison reads a frame's colour,
    whatever the accumulator held before it)."""
    opts = inputs.opts
    t32 = tables(inputs.scene, opts)
    t16 = tables(inputs.scene, opts, torch.bfloat16)
    tex16 = inputs.tex.to(torch.bfloat16)
    out = {"control": 0.0, "unchanged": 0.0, "half_batch": 0.0,
           "wrong_frame": 0.0}
    h = opts["height"]
    for frame in frames:
        with torch.no_grad():
            ref = frame_color(t32, inputs.tex, inputs.tex_w, inputs.tex_h,
                              opts, frame)
            low = frame_color(t16, tex16, inputs.tex_w, inputs.tex_h, opts,
                              frame).float()
            nxt = frame_color(t32, inputs.tex, inputs.tex_w, inputs.tex_h,
                              opts, frame + 1)
        pre = torch.zeros_like(ref)
        blend = frame_blend(frame)
        good = accumulate(pre, ref, blend)
        half = good.clone()
        half[:, h // 2:] = pre[:, h // 2:]
        posts = {"control": accumulate(pre, low, blend), "unchanged": pre,
                 "half_batch": half,
                 "wrong_frame": accumulate(pre, nxt, blend)}
        for k, post in posts.items():
            out[k] = max(out[k], check.pixels_off(pre, post, ref, frame,
                                                  checks["colour_atol"]))
    return out


def control(inputs, cell, look: bool = False) -> dict:
    """{variant: {"pixels_off": share}} of the control and the planted
    faults over frame 0 and the seed's checked frames placed in the
    first thousand."""
    frames = [0] + [int(f * 1000) for f in inputs.check_fractions]
    got = variants(inputs, cell.checks, frames)
    return {k: {"pixels_off": v} for k, v in got.items()}
