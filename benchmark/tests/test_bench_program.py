"""The program-traced pass (``harness/program.py``) and its nine readers,
on a trace and counters made by hand: the readers' arithmetic, nothing
read where the pass did not run, the entries' form, and the pass's
order, with the program's tracing on only inside it."""

import json
import types
from pathlib import Path

import pytest
import torch

from benchmark.harness import program, world
from benchmark.harness.spec import load_module, load_spec
from benchmark.harness.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = load_spec()
PROGRESSIVE = ["glass_720p.progressive", "textured_1080.progressive",
               "offline_4k.progressive"]
TRAIN = ["glass_720p.train", "textured_1080.train"]
LAYER = {"driver": "driver (render/driver.py)",
         "dispatch": "K-step dispatch (diff/inverse.py, diff/graph.py)",
         "a": "kernel A (kernels/megakernel.py)",
         "c": "kernel C (kernels/backward.py)",
         "step": "step (diff/grad.py, diff/inverse.py)"}
# name: (unit, better, layer, moves, cells)
NEW = {
    "frame_host_ms.frame": ("ms", "lower", "driver", "frame_mrays_s",
                            PROGRESSIVE),
    "dispatch_host_ms.train": ("ms", "lower", "dispatch", "train_mrays_s",
                               TRAIN),
    "kernel_a_lane_use.frame": ("%", "higher", "a", "frame_mrays_s",
                                PROGRESSIVE),
    "kernel_a_lane_use.train": ("%", "higher", "a", "train_mrays_s", TRAIN),
    "kernel_c_lane_use.train": ("%", "higher", "c", "train_mrays_s", TRAIN),
    "step_render_ms.train": ("ms", "lower", "step", "train_mrays_s", TRAIN),
    "step_loss_ms.train": ("ms", "lower", "step", "train_mrays_s", TRAIN),
    "step_backward_ms.train": ("ms", "lower", "step", "train_mrays_s", TRAIN),
    "step_adam_ms.train": ("ms", "lower", "step", "train_mrays_s", TRAIN),
}
# host spans in us, held: two frames of 100 and 300, one dispatch of 500
# with its replay (the device trace adds a frame that waited for the
# device, which the host metrics leave out); device: two kernels with a
# 50 us gap inside the dispatch
HOST = [("bench.call", 0.0, 400.0), ("driver.frame", 0.0, 100.0),
        ("frame.render", 10.0, 40.0), ("driver.frame", 200.0, 300.0),
        ("dispatch", 1000.0, 500.0), ("dispatch.replay", 1010.0, 400.0),
        ("cudaGraphLaunch", 1020.0, 10.0)]
OPS = [("render_planes_kernel", 1000.0, 100.0),
       ("bwd_tables_kernel", 1150.0, 100.0)]
READING = program.Reading(
    trace=Trace(calls=2, window_s=250e-6, ops=OPS,
                host=HOST + [("driver.frame", 2000.0, 5000.0)]),
    lanes={"kernel_a": (75, 100), "kernel_c": (96, 128)},
    phases_ms={"step.render": 0.25, "step.loss": 0.02,
               "step.backward": 0.9, "step.adam": 0.1},
    host=HOST)
WANT = {"frame_host_ms.frame": 0.2, "dispatch_host_ms.train": 0.5,
        "kernel_a_lane_use.frame": 75.0, "kernel_a_lane_use.train": 75.0,
        "kernel_c_lane_use.train": 75.0, "step_render_ms.train": 0.25,
        "step_loss_ms.train": 0.02, "step_backward_ms.train": 0.9,
        "step_adam_ms.train": 0.1}


class Ctx:
    """A traced run's context, with the pass's reading given."""

    def __init__(self, reading, trace=None):
        self.program, self.trace = reading, trace


@pytest.mark.parametrize("name", sorted(NEW))
def test_the_readers_on_a_reading_made_by_hand(name):
    assert load_module("metrics", name).read(Ctx(READING)) == \
        pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(NEW))
def test_nothing_is_read_where_the_pass_did_not_run(name):
    reader = load_module("metrics", name)
    assert reader.read(Ctx(None)) is None
    # a reading without the span, counter or phase reads nothing either
    empty = program.Reading(Trace(1, 0.0, [], []), {}, {}, [])
    assert reader.read(Ctx(empty)) is None


def test_no_pass_outside_a_traced_run():
    """No trace (an untraced run) or no seed on the command line: the
    pass does not run and every reader reads nothing."""
    ctx = types.SimpleNamespace(trace=None, cell=None)
    assert program.reading(ctx) is None and ctx.program is None
    assert load_module("metrics", "kernel_c_lane_use.train").read(
        types.SimpleNamespace(trace=None, cell=None)) is None


def test_gaps_are_named_by_the_programs_spans():
    # the gap 1100-1150 lies in ``dispatch.replay``: the innermost span
    # of the program, not the runtime call beside it
    assert program.named_gaps(READING.trace) == [
        ("dispatch.replay", pytest.approx(50e-6))]


def test_the_entries_keep_the_form():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    names = [m["name"] for m in SPEC["per_layer"]]
    # appended after the metrics the traced windows read
    assert names[-len(NEW):] == list(NEW)
    layers = {m["layer"] for m in SPEC["per_layer"][:-len(NEW)]}
    reported = {w: {m["name"] for m in SPEC["end_to_end"]
                    if w in m.get("workloads", [w])}
                for w in PROGRESSIVE + TRAIN}
    for name, (unit, better, layer, moves, cells) in NEW.items():
        m = entries[name]
        assert (m["unit"], m["better"], m["moves"], m["workloads"]) == (
            unit, better, moves, cells)
        assert m["layer"] == LAYER[layer] and m["layer"] in layers
        assert m["source"] == ("program_counter" if "lane_use" in name
                               else "program_span")
        assert all(moves in reported[w] for w in cells)
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").exists()
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_the_programs_tracing_is_off_outside_the_pass():
    """The program's tracing starts off in a run, so the measured window,
    the stream-held timing and the traced window run with it off."""
    profiling = program.tracing()
    assert profiling is not None and not profiling.enabled()


class FakeTracing:
    """The program's tracing API, logging each call and what the calls
    saw."""

    def __init__(self, log):
        self.log, self.on = log, False

    def enable(self):
        self.on = True
        self.log.append("enable")

    def disable(self):
        self.on = False
        self.log.append("disable")

    def enabled(self):
        return self.on

    def reset(self):
        self.log.append("reset")

    def read(self):
        self.log.append("read")
        return {"lanes": {"kernel_a": (3, 4)}, "phases_ms": {}}


@pytest.fixture
def fake_pass(monkeypatch):
    """``run_pass`` on the CPU with the program, the inputs and the
    profiler replaced by fakes; returns (log, options)."""
    log, opts = [], {"fail": False}
    tracing = FakeTracing(log)

    class Session:
        steps_per_call = 1

        def __init__(self, inputs, cell, seconds, device):
            log.append(("session", tracing.enabled()))

        def call(self):
            log.append(("call", tracing.enabled()))

        def release(self):
            log.append(("release", tracing.enabled()))

    def traced(call, n, path):
        assert path.name == "trace_c.train.program.json"
        for _ in range(n):
            call()
        if opts["fail"]:
            raise RuntimeError("the profiler failed")
        return Trace(n, 1e-3, [], [])

    def held_host(call, n, device, path):
        assert path.name == "trace_c.train.program_host.json"
        for _ in range(n):
            call()
        return [("dispatch", 0.0, 300.0)]

    monkeypatch.setattr(program, "tracing", lambda: tracing)
    monkeypatch.setattr(program, "run_seed", lambda: 7)
    monkeypatch.setattr(program, "make_inputs", lambda c, s, d: None)
    monkeypatch.setattr(program, "load_module",
                        lambda kind, name: types.SimpleNamespace(
                            Session=Session))
    monkeypatch.setattr(program, "traced", traced)
    monkeypatch.setattr(program, "held_host", held_host)
    monkeypatch.setattr(program, "sync", lambda device: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    return log, opts, tracing


def _ctx():
    cell = types.SimpleNamespace(name="c.train",
                                 traffic={"kind": "train", "trace_calls": 2,
                                          "calls_per_chunk": 1,
                                          "chunks_in_flight": 2,
                                          "held_calls": 1})
    return types.SimpleNamespace(trace=object(), cell=cell,
                                 world=world.Solo(torch.device("cuda", 0)))


def test_the_pass_runs_in_order_with_tracing_on_inside_it(fake_pass):
    log, _, tracing = fake_pass
    got = program.run_pass(_ctx(), log=lambda msg: None)
    # a session captured with tracing on for the device trace, then one
    # captured with it off for the host's spans, both run with it on
    assert log == ["enable", ("session", True), "enable", "reset",
                   ("call", True), ("call", True), "read", "disable",
                   ("release", False), ("session", False), "enable",
                   "reset", ("call", True), "disable", ("release", False)]
    assert got.lanes == {"kernel_a": (3, 4)} and not tracing.enabled()
    assert got.host == [("dispatch", 0.0, 300.0)]


def test_a_failed_pass_leaves_tracing_off(fake_pass):
    log, opts, tracing = fake_pass
    opts["fail"] = True
    with pytest.raises(RuntimeError):
        program.run_pass(_ctx(), log=lambda msg: None)
    assert log[-2:] == ["disable", ("release", False)]
    assert "read" not in log
    assert not tracing.enabled()


def test_a_failed_pass_leaves_its_metrics_out_and_the_run_on(fake_pass,
                                                             capsys):
    _, opts, tracing = fake_pass
    opts["fail"] = True
    ctx = _ctx()
    reader = load_module("metrics", "kernel_a_lane_use.train")
    assert reader.read(ctx) is None and ctx.program is None
    assert "its metrics are left out" in capsys.readouterr().err
    assert not tracing.enabled()


def test_held_host_keeps_the_held_calls_and_takes_fewer_where_drained(
        monkeypatch, tmp_path):
    """``held_host`` over a ``held_ms`` whose stream drains with more
    than two calls: the spans of the two held calls, the warm-up call's
    and the drained attempts' left out."""
    def held_ms(call, n, device):
        call()                          # the warm-up call
        if n > 2:
            for _ in range(n):
                call()
            raise RuntimeError("held_ms: the stream drained while calls "
                               "were enqueued")
        for _ in range(n):
            call()
        return 1.0, 1.0

    def call():
        with torch.profiler.record_function("dispatch"):
            pass

    monkeypatch.setattr(program, "held_ms", held_ms)
    host = program.held_host(call, 4, None, tmp_path / "host.json")
    assert [h[0] for h in host].count("bench.call") == 2
    assert [h[0] for h in host].count("dispatch") == 2
    assert (tmp_path / "host.json").exists()
