"""On the card (marker ``cuda``; each test skips without one): one short
run of every cell prints a result line that keeps the contract, and the
lower-precision control fails the limits of a progressive cell at its
own size. Run on the card with

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_cell, load_module, load_spec

ROOT = Path(__file__).resolve().parents[2]
SPEC = load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]

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
