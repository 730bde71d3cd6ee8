"""On the card (marker ``cuda``; each test skips without one): one short
run of every cell prints a result line that keeps the contract, the
lower-precision control fails the limits of a progressive cell and of
the checkpoint saves at their own size, and a training cell's
``grad_gap`` holds the program's first gradient under its limit and
fails it scaled by 2 or by 0.5 in the program's backward; and a world
of two ranks sharing the card over gloo runs the tiny sharded cells
through ``main.run`` and comes out correct. Run on the card with

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import check, main, port, spec
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_cell, load_module, load_spec
from benchmark.tests.test_bench_correct import small_cell
from benchmark.tests.test_bench_world import sharded_copy
from cpuperformanceraytracer_tpu_torch.diff import grad
from planted import backward_scaled

ROOT = Path(__file__).resolve().parents[2]
SPEC = load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN = [c for c in CELLS if load_cell(c).traffic["kind"] == "train"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_keeps_the_contract(card, cell, trace):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    cell_spec = load_cell(cell)
    wanted = cell_spec.per_layer if trace else cell_spec.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        for name, m in result["metrics"].items():
            if "roofline" in name:
                assert 0 < m["value"] <= 105, (name, m)
    else:
        assert {m["name"] for m in wanted} == set(result["metrics"])


def test_the_control_fails_at_the_cells_size(card):
    c = load_cell("glass_720p.progressive")
    inputs = make_inputs(c, 2 ** 31 + 3, card)
    got = load_module("kinds", "progressive").variants(inputs, c.checks,
                                                       [0, 500])
    limit = c.checks["limits"]["pixels_off"]
    assert all(v > limit for v in got.values()), got


def test_the_save_control_fails_at_the_cells_size(card):
    """The sound save reads 0 at 3840x2160; the control (the accumulator
    rounded to bfloat16) and each planted fault read above the limit."""
    c = load_cell("offline_4k.checkpointed")
    inputs = make_inputs(c, 2 ** 31 + 7, card)
    got = load_module("kinds", "checkpointed").save_variants(inputs, c)
    assert got.pop("sound") == 0.0
    limit = c.checks["limits"]["saves_off"]
    assert all(v > limit for v in got.values()), got


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("factor", [1.0, 2.0, 0.5])
def test_the_gradient_check_at_the_cells_size(card, cell, factor,
                                              monkeypatch):
    """The program's first gradient (``port.gradients``: kernels A to D)
    with its frame's backward scaled by ``factor`` (1: sound) against the
    reference's first step."""
    c = load_cell(cell)
    inputs = make_inputs(c, 2 ** 31 + 13, card)
    problem = port.train_problem(inputs, card)
    monkeypatch.setattr(grad, "render_frame_diff", backward_scaled(
        grad.render_frame_diff, factor))
    loss, grads = port.gradients(problem, inputs.params0, inputs.frame0)
    ref = check.reference_train(inputs, c.traffic, steps=1)
    got = check.compare_train(inputs, {"losses": [loss], "grads": grads},
                              ref)
    limit = c.checks["limits"]["grad_gap"]
    assert got["loss_gap"] <= c.checks["limits"]["loss_gap"], got
    assert (got["grad_gap"] <= limit) == (factor == 1.0), got


@pytest.mark.parametrize("mix", ["progressive", "checkpointed"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_world_of_two_ranks_sharing_the_card_is_correct(card, mix, trace,
                                                          tmp_path,
                                                          monkeypatch):
    """``glass_sharded`` (mesh px 2, ``test_bench_world.sharded_copy``)
    at the small size as two ranks on the one card, over gloo, through
    ``main.run``: correct, both ranks counted; traced, every rank's trace
    written and read."""
    root = sharded_copy(tmp_path / "copy")
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(main, "load_cell",
                        lambda name: small_cell(name, root=root))
    cell = f"glass_sharded.{mix}"
    result, _ = main.run(cell, 2 ** 31 + 41, 1.0, bool(trace), card,
                         time.perf_counter())
    assert result["correct"], result["checks"]
    dev = result["device"]
    assert dev["count"] == 2 and dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        for r in range(2):
            assert (ROOT / "build" / "benchmark"
                    / f"trace_{cell}.rank{r}.json").exists()
