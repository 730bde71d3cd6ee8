"""The program-traced pass: the program's own tracing (its
``utils/profiling``: spans, step-phase events, lane counters) switched
on for a fresh session of the cell, after the measured window, the
stream-held timing, the traced window and the reference's check, which
all run with it off.

The pass runs once in a traced run, at the first call of a reader of one
of its metrics (``benchmark/metrics/``; the harness reads the per-layer
metrics after the check, in ``BENCHMARK.json``'s order, so the measured
session has been released by then). In order, with the inputs made
anew from the run's seed:

1. tracing on; a fresh session of the cell's traffic kind (a training
   session captures a traced graph); the counters reset;
   ``trace_calls`` calls profiled as the traced window profiles them
   (``trace.traced``) into ``build/benchmark/trace_<cell>.program.json``;
   the counters read (lanes, phases); tracing off; the session
   released. The ten longest idle gaps of this trace are logged, each
   named by the innermost of the program's spans around it.
2. a fresh session built with tracing off (a graph without the phases'
   events, as the measured path runs it), then tracing on;
   ``held_calls`` calls timed as the stream-held timing times them
   (``window.held_ms``: a sleep kernel holds the stream while the host
   enqueues them), under a profiler of the host alone, into
   ``trace_<cell>.program_host.json``, whose spans give their host
   time; tracing off; the session released.

The host spans come from the second trace, in which no call waits for
the device: in the first, 64 textured frames fill the launch queue, and
a graph with the phases' 80 event nodes takes 1-3 ms of the host to
launch against 0.3-0.5 ms without them. A span's host time holds the
host profiler's own cost for each operation it records.

A pass that fails is logged and its metrics are left out; the run's
other metrics stand.

In a cell of several ranks the pass's sessions are built on every rank
and every call is made on every rank (``harness/world.py``); what it
reads is rank 0's.

The benchmark reaches the program through the adapter (``port.py``):
the tracing module is the one its imports loaded with the program. A
program without one, or without ``enable``, has no pass, and the pass's
metrics are left out of its result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import sys
import traceback

import torch

from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import ROOT, load_module
from benchmark.harness.trace import Trace, read_chrome_trace, traced
from benchmark.harness.window import held_ms, sync

# the program's tracing module, as the adapter's imports load it
TRACING = "cpuperformanceraytracer_tpu_torch.utils.profiling"
# host spans that name an idle gap: the program's, then the harness's own
SPANS = ("driver.", "frame.", "dispatch", "step.", "bench.")
STEP_PHASES = ("step.render", "step.loss", "step.backward", "step.adam")


@dataclasses.dataclass
class Reading:
    trace: Trace           # the pass's profiled calls
    lanes: dict            # {kernel: (lanes that ran, lane slots)}
    phases_ms: dict        # {phase: mean device ms a step}
    host: list             # (name, start us, us) of the held calls


def tracing():
    """The program's tracing module, or None where it has none with
    ``enable``."""
    from benchmark.harness import port  # noqa: F401  (loads the program)

    module = sys.modules.get(TRACING)
    return module if hasattr(module, "enable") else None


def run_seed():
    """The run's ``--seed`` from its command line (``benchmark/run.py``),
    or None."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int)
    return p.parse_known_args(sys.argv[1:])[0].seed


def reading(ctx):
    """This run's ``Reading``, the pass run at the first call, or None
    where the pass did not run or failed."""
    if "program" not in vars(ctx):
        try:
            ctx.program = run_pass(ctx)
        except Exception:
            traceback.print_exc()
            print("program pass: failed; its metrics are left out",
                  file=sys.stderr, flush=True)
            ctx.program = None
    return ctx.program


def named_gaps(tr: Trace, top: int = 10) -> list:
    """[(span, seconds)] of the ``top`` longest idle gaps of the device,
    each named by the innermost program or harness span around it."""
    spans = [h for h in tr.host if h[0].startswith(SPANS)]
    return Trace(tr.calls, tr.window_s, tr.ops, spans).gaps(top)


def held_host(call, n: int, device, path):
    """Host events (name, start us, us) of ``n`` calls timed by
    ``held_ms`` (the stream held full, so that no call waits for the
    device) under a profiler of the host alone, its warm-up call left
    out; fewer calls where the stream drained, and None where it drained
    with one."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def marked():
        with record_function("bench.call"):
            call()

    for count in range(n, 0, -1):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            try:
                held_ms(marked, count, device)
            except RuntimeError as e:
                if "drained" not in str(e):
                    raise
                continue
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        host = read_chrome_trace(path)[1]
        first = sorted(h[1] for h in host if h[0] == "bench.call")[-count]
        return [h for h in host if h[1] >= first]
    return None


@contextlib.contextmanager
def fresh_session(profiling, world, kind, inputs, cell, device,
                  captured_on: bool):
    """A fresh session of the cell, on every rank of the run's ``world``,
    built with the program's tracing on or off (a training session
    captures its graph then), yielded with tracing on and the counters
    reset; at the end tracing is off and the session released. The
    program's tracing is rank 0's: a follower's runs with it off."""
    session = None
    if captured_on:
        profiling.enable()
    try:
        session = world.session(kind, inputs, cell, 0.0)
        sync(device)
        profiling.enable()
        profiling.reset()
        yield session
    finally:
        profiling.disable()
        if session is not None:
            session.release()
        session = None
        gc.collect()
        torch.cuda.empty_cache()


def run_pass(ctx, log=None):
    """The pass over ``ctx.cell`` (see the module's doc), or None where
    it cannot run: no traced run, no card, no seed, or a program without
    tracing."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    seed = run_seed()
    if ctx.trace is None or seed is None or not torch.cuda.is_available():
        return None
    profiling = tracing()
    if profiling is None:
        log("program pass: the program has no tracing; its metrics are "
            "left out")
        return None
    device = torch.device("cuda", 0)
    cell = ctx.cell
    traffic = cell.traffic
    kind = load_module("kinds", traffic["kind"])
    path = ROOT / "build" / "benchmark" / f"trace_{cell.name}.program.json"
    inputs = make_inputs(cell, seed, device)
    with fresh_session(profiling, ctx.world, kind, inputs, cell, device,
                       True) as session:
        tr = traced(session.call, traffic["trace_calls"], path)
        got = profiling.read()
        steps = tr.calls * session.steps_per_call
    with fresh_session(profiling, ctx.world, kind, inputs, cell, device,
                       False) as session:
        host = held_host(session.call, traffic["held_calls"], device,
                         path.with_name(f"trace_{cell.name}.program_host.json"))
    del inputs, session
    if host is None:
        log("program pass: the stream drained under every held call; the "
            "host spans are left out")
    phases = got["phases_ms"]
    log(f"program pass: lanes {got['lanes']}; phases ms a step {phases}")
    if all(p in phases for p in STEP_PHASES):
        log(f"program pass: the step's phases sum to "
            f"{sum(phases[p] for p in STEP_PHASES):.6f} ms; the traced "
            f"calls' device span a step {tr.window_s * 1e3 / steps:.6f} ms")
    for span in ("driver.frame", "dispatch"):
        for what, events in (("traced", tr.host), ("held", host or [])):
            ms = sorted(d / 1e3 for name, _, d in events if name == span)
            if ms:
                log(f"program pass: {span} host ms {what}: min {ms[0]:.6f},"
                    f" median {ms[len(ms) // 2]:.6f}, max {ms[-1]:.6f} of "
                    f"{len(ms)}")
    log("program pass: idle gaps by span: " + ", ".join(
        f"{name} {sec * 1e6:.1f} us" for name, sec in named_gaps(tr)))
    return Reading(tr, got["lanes"], phases, host or [])


def host_ms(ctx, span: str):
    """Mean host ms of the program's span ``span`` over the pass's calls
    enqueued behind a sleep that holds the stream."""
    r = reading(ctx)
    if r is None:
        return None
    durations = [d for name, _, d in r.host if name == span]
    return sum(durations) / len(durations) / 1e3 if durations else None


def lane_use(ctx, kernel: str):
    """Percent of ``kernel``'s lane slots in which a lane ran, over the
    pass's calls: 100 * live / slots of its counter."""
    r = reading(ctx)
    live, slots = r.lanes.get(kernel, (0, 0)) if r else (0, 0)
    return 100.0 * live / slots if slots else None


def phase_ms(ctx, phase: str):
    """Mean device ms a step between the two boundary events of a step's
    phase (the gaps between its operations included)."""
    r = reading(ctx)
    return None if r is None else r.phases_ms.get(phase)
