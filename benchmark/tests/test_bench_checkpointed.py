"""The ``checkpointed`` kind at a tiny size on the CPU: its draws and
launches, the window's rule of whole intervals, the wait for saves that
are still being written, the comparison of a save with its clone, and
the readers of ``save_ms.checkpointed`` and ``offline_mrays_s``."""

import threading
import time
import types

import pytest
import torch

from benchmark.harness import check, port, spec, window
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_module
from benchmark.tests.test_bench_correct import HostClock, small_cell

CPU = torch.device("cpu")
CELL = "offline_4k.checkpointed"
kind = load_module("kinds", "checkpointed")


@pytest.fixture
def session(monkeypatch, tmp_path):
    """(session, inputs, cell) of the small cell on the program's
    plain-PyTorch kernels, timed by the host clock, its saves under a
    directory of its own."""
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(port, "BACKEND", "torch")
    monkeypatch.setattr(window, "Clock", HostClock)
    cell = small_cell(CELL)
    inputs = make_inputs(cell, 2 ** 31 + 21, CPU)
    s = kind.Session(inputs, cell, 0.0, CPU)
    yield s, inputs, cell
    s.release()


def test_draw_places_the_checked_frames_in_the_first_intervals():
    cell = small_cell(CELL)
    t = cell.traffic
    for seed in range(20):
        got = kind.draw(cell, torch.Generator().manual_seed(seed), CPU, {},
                        None)
        assert len(got["check_frames"]) == cell.checks["frames_sampled"]
        assert all(0 < f < t["min_saves"] * t["save_every"]
                   for f in got["check_frames"])
        assert got["check_fractions"] == got["check_offsets"] == []


def test_launches_are_the_progressive_frames():
    cell = small_cell(CELL)
    progressive = load_module("kinds", "progressive")
    assert kind.launches(cell.render, cell.traffic) == progressive.launches(
        cell.render, cell.traffic) == {"kernel_a": 1, "kernel_b": 1}


def test_the_window_holds_min_saves_whole_intervals(session):
    """A window of no seconds still runs until ``min_saves`` intervals
    are done, each ended by its save, and stops there."""
    s, _, cell = session
    t = cell.traffic
    w = window.run_window(s, 0.0, t["calls_per_chunk"],
                          t["chunks_in_flight"])
    assert w.calls == t["min_saves"] * t["save_every"]
    assert [f for _, f, _, _ in s.saves] == [
        t["save_every"] * (i + 1) for i in range(t["min_saves"])]
    assert s.in_window == t["min_saves"] and not s.pending()


def test_pending_until_the_saves_are_made(session):
    s, _, cell = session
    s.snaps = {n: None for n in s._planned}  # the frames' checks done
    every = cell.traffic["save_every"]
    for _ in range(cell.traffic["min_saves"]):
        assert s.pending()
        for _ in range(every):
            s.call()
    assert not s.pending()


def test_drain_waits_for_a_save_still_being_written(session, tmp_path):
    s, inputs, _ = session
    path = tmp_path / "late.npz"
    want = torch.rand(3, 16, 32)
    s.saves = [(path, 8, want, 1.0)]
    late = threading.Timer(0.2, kind.reference_save,
                           (path, want, 8, inputs.opts, 1))
    t0 = time.perf_counter()
    late.start()
    try:
        s.drain()
    finally:
        late.join(10)
    assert not late.is_alive()
    assert 0.2 <= time.perf_counter() - t0 < s.wait_s
    assert kind.whole(path) and s.in_window == 1
    assert check.save_fault(path, want, 8, 1, inputs.opts) is None


def test_drain_gives_up_and_the_save_counts_as_missing(session, tmp_path):
    s, inputs, _ = session
    s.wait_s = 0.05
    path = tmp_path / "never.npz"
    s.saves = [(path, 8, torch.zeros(3, 16, 32), 1.0)]
    t0 = time.perf_counter()
    s.drain()
    assert time.perf_counter() - t0 < 5
    assert check.save_fault(path, torch.zeros(3, 16, 32), 8, 1,
                            inputs.opts) == "missing"


def _faults(tmp_path, opts, want, prev):
    """{fault: path} of saves with one fault planted each."""
    out = {}

    def save(name, accum=want, frame=8, version=1, config=opts):
        out[name] = tmp_path / f"{name}.npz"
        kind.reference_save(out[name], accum, frame, config, version)

    save("sound")
    save("stale", accum=prev)
    save("wrong_frame", frame=9)
    save("bfloat16", accum=want.to(torch.bfloat16).float())
    save("version", version=2)
    save("config", config=dict(opts, width=opts["width"] + 1))
    save("float64", accum=want.double())
    out["truncated"] = tmp_path / "truncated.npz"
    out["truncated"].write_bytes(out["sound"].read_bytes()[:-100])
    out["missing"] = tmp_path / "missing.npz"
    return out


def test_save_fault_finds_each_fault(tmp_path):
    opts = small_cell(CELL).render
    want = torch.rand(3, 16, 32) * 4
    paths = _faults(tmp_path, opts, want, want * 0.5)
    got = {k: check.save_fault(p, want, 8, 1, opts) for k, p in paths.items()}
    assert got.pop("sound") is None
    assert got.pop("missing") == "missing"
    assert got.pop("truncated").startswith("unreadable")
    assert all(v is not None for v in got.values()), got


def test_the_programs_save_is_a_sound_save(session):
    """The program's own save through the adapter, at the frame it is
    at, reads back as a bit-exact copy of its accumulator."""
    s, inputs, _ = session
    for _ in range(3):
        s.program.call()
    path = s.dir / "direct.npz"
    s.program.save(str(path))
    assert check.save_fault(path, s.program.accum.clone(), 3, 1,
                            inputs.opts) is None


def test_the_check_reads_the_windows_saves_and_removes_the_files(session):
    s, inputs, cell = session
    t = cell.traffic
    window.run_window(s, 0.0, t["calls_per_chunk"], t["chunks_in_flight"])
    for _ in range(t["save_every"]):   # a save after the window
        s.call()
    ms = [m for *_, m in s.saves]
    s.release()
    got, counts = s.check(inputs, cell, log=lambda msg: None)
    assert got["saves_off"] == 0 and got["pixels_off"] == 0
    assert counts["save_ms"] == pytest.approx(
        sum(ms[:t["min_saves"]]) / t["min_saves"])
    assert not s.dir.exists()


def test_no_save_reads_as_all_saves_off(session):
    s, inputs, cell = session
    s.before(0)
    s.call()
    s.after(0)
    assert not s.saves
    s.release()
    got, counts = s.check(inputs, cell, log=lambda msg: None)
    assert got["saves_off"] == 1.0 and "save_ms" not in counts


def test_the_readers_on_a_stub_window():
    ctx = types.SimpleNamespace(
        rays_per_call=3840 * 2160, work={"save_ms": 8500.0},
        window=window.Window(calls=256, seconds=17.5, call_ms=[]))
    assert load_module("metrics", "offline_mrays_s").read(ctx) == \
        pytest.approx(3840 * 2160 * 256 / 17.5 / 1e6)
    assert load_module("metrics", "save_ms.checkpointed").read(ctx) == 8500.0
    ctx.work = {}
    assert load_module("metrics", "save_ms.checkpointed").read(ctx) is None
