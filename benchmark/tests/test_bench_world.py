"""Worlds of ranks (``harness/world.py``) on the CPU, over gloo: tiny
sharded progressive and checkpointed cells, added to a copy of the
benchmark as new files and entries alone, run as two processes through
``main.run``, come out correct with the same accumulators and saves as
one rank, and report both ranks; a fault on the follower's rows fails
the check; a slower follower sets the frame tail; a follower that
loads a forbidden module has the run refused; a follower that raises or
falls silent ends the run within bounds with no process left; and a
world of one starts no process and
forms no process group."""

import functools
import json
import multiprocessing
import os
import shutil
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from benchmark.harness import check, main, world
from benchmark.tests.test_bench_correct import (  # noqa: F401 (on_cpu: a fixture)
    on_cpu,
    small_cell,
)
from planted import follower_fault

ROOT = Path(__file__).resolve().parents[2]
SHARDED = "glass_sharded.progressive"
SEED = 2 ** 31 + 17


def sharded_copy(root: Path) -> Path:
    """A copy of the benchmark at ``root`` with cells added as new files
    and entries alone: ``glass_sharded``, ``glass_720p``'s configuration
    with the mesh {"px": 2, "spp": 1}, under the progressive and the
    checkpointed mixes on 2 chips, and ``glass_720p`` under the
    checkpointed mix on one, each with the checks of the benchmark's cell
    of its mix. Returns ``root``."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    cfg = json.loads((b / "configs/glass_720p.json").read_text())
    cfg.update(name="glass_sharded", mesh={"px": 2, "spp": 1})
    (b / "configs/glass_sharded.json").write_text(json.dumps(cfg))
    spec_ = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec_["configs"].append({"name": "glass_sharded", "source": "x",
                             "file": "benchmark/configs/glass_sharded.json",
                             "reduced": [], "why": "x"})
    twins = {"progressive": "glass_720p.progressive",
             "checkpointed": "offline_4k.checkpointed"}
    for config, mix, chips in (("glass_sharded", "progressive", 2),
                               ("glass_sharded", "checkpointed", 2),
                               ("glass_720p", "checkpointed", 1)):
        name = f"{config}.{mix}"
        shutil.copy(b / f"checks/{twins[mix]}.json", b / f"checks/{name}.json")
        spec_["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": chips,
                                   "why": "x"})
        for m in spec_["end_to_end"] + spec_["per_layer"]:
            if twins[mix] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec_))
    return root


@pytest.fixture
def sharded(tmp_path, on_cpu, monkeypatch):
    """Runs load their cells, at the small size, from a ``sharded_copy``;
    each follower writes its pid under ``tmp_path / "pids"``."""
    root = sharded_copy(tmp_path / "copy")
    monkeypatch.setattr(main, "load_cell",
                        lambda name: small_cell(name, root=root))
    pids = tmp_path / "pids"
    pids.mkdir()
    monkeypatch.setattr(world, "FOLLOWER_SETUP", functools.partial(
        follower_fault, None, None, pids))
    return pids


def _run(cell, seconds=0.05, log=None):
    result, _ = main.run(cell, SEED, seconds, False, torch.device("cpu"),
                         time.perf_counter(), log=log or (lambda msg: None))
    return result


def _no_process_left(pids: Path) -> bool:
    """True where no follower of the run is alive and no child is left."""
    for f in pids.glob("*.pid"):
        try:
            os.kill(int(f.read_text()), 0)
            return False
        except ProcessLookupError:
            pass
    return not multiprocessing.active_children()


@pytest.mark.parametrize("mix", ["progressive", "checkpointed"])
def test_a_sharded_run_is_correct_and_bit_equal_to_one_rank(sharded,
                                                            monkeypatch, mix):
    """With a window of no seconds both runs check the same frames (frame
    0 and those the seed places, in the first chunk or the first
    intervals) and make the same saves: every accumulator the 2-rank run
    assembles, and the clone of every save it compares, is the 1-rank
    run's, bit for bit."""
    seen = {}
    pixels_off, save_fault = check.pixels_off, check.save_fault

    def keep_frame(pre, post, color, frame, atol):
        seen[("frame", frame)] = post.clone()
        return pixels_off(pre, post, color, frame, atol)

    def keep_save(path, want, frame, version, opts):
        seen[("save", frame)] = want.clone()
        return save_fault(path, want, frame, version, opts)

    monkeypatch.setattr(check, "pixels_off", keep_frame)
    monkeypatch.setattr(check, "save_fault", keep_save)
    one = _run(f"glass_720p.{mix}", 0.0)
    alone, seen = seen, {}
    logged = []
    two = _run(f"glass_sharded.{mix}", 0.0, logged.append)
    assert one["correct"] and two["correct"], (one["checks"], two["checks"])
    # the window's drain joined the follower, which timed its own calls
    assert [m for m in logged if m.startswith("rank 1: peak 0 bytes; ")]
    assert (one["device"]["count"], two["device"]["count"]) == (1, 2)
    assert two["attempted"] == one["attempted"]
    assert sorted(seen) == sorted(alone) and ("frame", 0) in seen
    assert (mix == "checkpointed") == any(k[0] == "save" for k in seen)
    assert all(torch.equal(seen[k], alone[k]) for k in alone)
    assert not dist.is_initialized() and _no_process_left(sharded)


def test_an_idle_follower_fails_the_check(sharded, monkeypatch):
    """Rank 1's frames leave its rows of the accumulator as they were:
    the assembled accumulators are off on half the pixels."""
    monkeypatch.setattr(world, "FOLLOWER_SETUP", functools.partial(
        follower_fault, "idle", 1, sharded))
    result = _run(SHARDED)
    assert not result["correct"]
    assert result["checks"]["pixels_off"]["value"] >= 0.4
    assert _no_process_left(sharded)


def test_a_slow_follower_sets_the_frame_tail(sharded, monkeypatch):
    """Rank 1's frames take 150 ms more than rank 0's: the run is still
    correct, and its ``frame_ms_p95`` is that of the slower rank's
    frames, not rank 0's."""
    monkeypatch.setattr(world, "FOLLOWER_SETUP", functools.partial(
        follower_fault, "slow", 1, sharded))
    logged = []
    result = _run(SHARDED, log=logged.append)
    assert result["correct"], result["checks"]
    rank0 = float(next(m for m in logged if m.startswith("rank 0: peak"))
                  .split("last tenth ")[1].split(",")[0])
    p95 = result["metrics"]["frame_ms_p95"]["value"]
    assert p95 >= 150.0 > rank0
    assert _no_process_left(sharded)


def test_a_follower_that_loads_a_forbidden_module_is_refused(sharded,
                                                             monkeypatch):
    """Rank 1's frames load a module named ``flax``: rank 0's process
    holds none, yet the run is refused and names it."""
    monkeypatch.setattr(world, "FOLLOWER_SETUP", functools.partial(
        follower_fault, "flax", 1, sharded))
    with pytest.raises(world.Forbidden, match="loaded on rank 1: flax"):
        _run(SHARDED)
    assert "flax" not in world.forbidden_modules()
    assert not dist.is_initialized() and _no_process_left(sharded)


@pytest.mark.parametrize("fault, mix, said", [
    ("raise", "progressive", "rank 1 ended"),
    # on a busy host a chunk of the window may outlast the short ANSWER_S
    ("silent", "progressive", "rank 1 has not answered|rank 0 has waited"),
    ("silent", "checkpointed", "rank 0 has waited in a call")],
    ids=["raise", "silent", "silent_in_a_save"])
def test_a_failed_or_silent_follower_ends_the_run(sharded, monkeypatch,
                                                  fault, mix, said):
    """Rank 1 raises in its window's fourth frame, or never returns from
    it: rank 0 raises ``WorldError`` within bounds (``ANSWER_S`` after it
    began to wait at the window's end, or, held in the first save's
    collective, after it last told the follower anything), and no
    process is left."""
    monkeypatch.setattr(world, "FOLLOWER_SETUP", functools.partial(
        follower_fault, fault, 1, sharded))
    monkeypatch.setattr(world, "ANSWER_S", 3.0)
    t0 = time.perf_counter()
    with pytest.raises(world.WorldError, match=said):
        _run(f"glass_sharded.{mix}")
    assert time.perf_counter() - t0 < 90
    assert not dist.is_initialized() and _no_process_left(sharded)
    assert len(list(sharded.glob("*.pid"))) == 1


def test_a_world_of_one_starts_no_process_and_forms_no_group(on_cpu,
                                                             monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a world of one started a world")

    monkeypatch.setattr(world, "World", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(multiprocessing, "get_context", refuse)
    result = _run("glass_720p.progressive")
    assert result["correct"] and result["device"]["count"] == 1
    assert not dist.is_initialized() and not multiprocessing.active_children()


def test_assemble_stacks_the_px_blocks_and_marks_a_spp_column_that_differs():
    rows = [torch.full((3, 2, 4), float(r)) for r in range(4)]
    whole = world.assemble(rows, (4, 1))
    assert whole.shape == (3, 8, 4)
    assert torch.equal(whole[:, 2:4], rows[1])
    # px 2, spp 2: ranks 0, 1 hold rows 0-1, ranks 2, 3 rows 2-3
    same = [rows[0], rows[0].clone(), rows[2], rows[2].clone()]
    assert torch.equal(world.assemble(same, (2, 2)),
                       torch.cat([rows[0], rows[2]], dim=1))
    same[3][1, 1, 2] = 5.0
    got = world.assemble(same, (2, 2))
    assert got.isnan().sum() == 1 and got[1, 3, 2].isnan()
