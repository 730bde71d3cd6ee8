"""One run of one cell.

Set-up (a cell of several chips: its world of ranks, one card a rank,
``harness/world.py``; inputs from the seed on the device, the program's
entry point built and warmed on every rank: a progressive render's
warm-up frames, or the training loop's first dispatch, which captures its
CUDA graph); the measured window; with ``--trace 1`` the stream-held
timing and the traced window after it; the program's state freed; the
comparison with the reference; and the result: the last line of standard
output is one JSON object, and the numbers compared, each beside its
limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import torch

from benchmark.harness import world
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import ROOT, load_cell, load_module, load_spec
from benchmark.harness.window import held_ms, run_window, sync


class Context:
    """What a metric's reader reads: the cell, its render settings, the
    window (rank 0's), the set-up time, and in a traced run the
    stream-held timing, the trace (of the rank that sets the pace) and the
    work counts of the reference's check; ``ranks``, the device ms of each
    call of the window on each rank, in rank order; and the run's
    ``world`` (``harness/world.py``), in which the program's pass builds
    its sessions."""

    def __init__(self, cell, opts, window, setup_s, steps_per_call,
                 held=None, trace=None, work=None, ranks=None, world=None):
        self.cell, self.opts, self.window = cell, opts, window
        self.setup_s, self.steps_per_call = setup_s, steps_per_call
        self.held, self.trace, self.work = held, trace, work or {}
        self.ranks, self.world = ranks, world

    @property
    def rays_per_call(self) -> int:
        o = self.opts
        return o["width"] * o["height"] * o["spp"] * self.steps_per_call


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), or its name alone."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name()


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=None):
    """One run; returns (result dict, [(check name, value, limit)])."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(cell_name)
    with world.start(cell, seed, device, log) as team:
        out = run_in(team, cell, seed, seconds, trace, device, t_start, log)
        # once the window has closed, what each follower's process holds
        elsewhere = team.loaded()
    if elsewhere:
        raise world.Forbidden("; ".join(
            f"loaded on rank {r}: {', '.join(names)}"
            for r, names in sorted(elsewhere.items())))
    return out


def run_in(team, cell, seed: int, seconds: float, trace: bool, device,
           t_start: float, log):
    """The run of ``cell`` as rank 0 of its world ``team``."""
    traffic = cell.traffic
    kind = load_module("kinds", traffic["kind"])
    inputs = make_inputs(cell, seed, device)
    session = team.session(kind, inputs, cell, seconds)
    sync(device)

    t0 = time.perf_counter()
    window = run_window(session, seconds, traffic["calls_per_chunk"],
                        traffic["chunks_in_flight"])
    setup_s = t0 - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tenth = max(1, window.calls // 10)
    log(f"window: {window.calls} calls in {window.seconds:.6f} s; device ms "
        f"a call, first tenth {sum(window.call_ms[:tenth]) / tenth:.6f}, "
        f"last tenth {sum(window.call_ms[-tenth:]) / tenth:.6f}")
    # each rank's (peak bytes, device ms of each call)
    ranks = [(peak, window.call_ms), *team.drained]
    for r, (p, ms) in enumerate(ranks):
        t = max(1, len(ms) // 10)
        log(f"rank {r}: peak {p} bytes; device ms a call, first tenth "
            f"{sum(ms[:t]) / t:.6f}, last tenth {sum(ms[-t:]) / t:.6f}, "
            f"sum {sum(ms):.6f}")
    peak = max(p for p, _ in ranks)

    held = tr = None
    if trace:
        held = held_ms(session.call, traffic["held_calls"], device)
        path = ROOT / "build" / "benchmark" / f"trace_{cell.name}.json"
        traces = team.traced(session, traffic["trace_calls"], path)
        # the readers read the trace of the rank that sets the pace
        tr = max(traces, key=lambda t: t.busy_s)
        if len(traces) > 1:
            log("traced: " + ", ".join(
                f"rank {r} busy {t.busy_s:.6f} s of {t.window_s:.6f} s"
                for r, t in enumerate(traces))
                + f"; read: rank {traces.index(tr)}'s")

    # the program's state is freed before the reference runs
    session.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    got, counts = session.check(inputs, cell, log)
    log(f"reference check: {time.perf_counter() - t_ref:.3f} s")
    compared = [(name, got[name], limit)
                for name, limit in cell.checks["limits"].items()]
    correct = all(v <= lim for _, v, lim in compared)

    o = inputs.opts
    work = {"n_px": o["width"] * o["height"], "spp": o["spp"],
            "n_quads": inputs.scene["quads"].shape[0],
            "n_spheres": inputs.scene["centers"].shape[0],
            "n_materials": inputs.scene["materials"]["albedo"].shape[0],
            "n_texels": inputs.tex_w * inputs.tex_h, **counts}
    ctx = Context(cell, o, window, setup_s, session.steps_per_call, held,
                  tr, work, [ms for _, ms in ranks], team)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": team.size, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window.calls,
              "failed": 0, "metrics": metrics, "device": dev}
    if tr is not None:
        # busy seconds averaged over the ranks; the longest traced window
        dev["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        dev["window_s"] = max(t.window_s for t in traces)
        seen = []
        made = kind.launches(o, traffic)
        for k in sorted(p.stem for p in (ROOT / "benchmark" / "work").glob(
                "kernel_*.py")):
            w = load_module("work", k)
            found = sum(n for n, _ in tr.matching(w.ANCHOR).values())
            seen.append(f"{k} {found}/{made.get(k, 0) * tr.calls}")
        log("traced launches seen/made: " + ", ".join(seen)
            + f"; held {held[0]:.6f} device ms, {held[1]:.6f} host ms a call")
        ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {
            "device_ops": [[name[:160], t] for name, (_, t) in ops],
            "idle_gaps": [[name[:160], t] for name, t in tr.gaps(10)]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in compared}
    return result, compared


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cells = {c["name"]: c for c in load_spec()["workloads"]}
    chips = cells.get(args.workload, {}).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}; torch {torch.__version__}", file=sys.stderr,
          flush=True)
    try:
        result, compared = run(args.workload, args.seed, args.seconds,
                               bool(args.trace), device, t_start)
    except world.Forbidden as e:
        print(f"error: {e}", file=sys.stderr)
        return 4
    loaded = world.forbidden_modules()
    if loaded:
        print(f"error: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for name, value, limit in compared:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
