"""The harness runs on data: every entry of ``BENCHMARK.json`` resolves to
its files, a new configuration, mix or metric is picked up from new files
alone, the file keeps to the benchmark's contract, the inputs follow the
seed, and a run without a card fails without falling back to the CPU."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import window
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_cell, load_module, load_spec

ROOT = Path(__file__).resolve().parents[2]
SPEC = load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert ((2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90
            + 1200) <= 43200


def test_names_units_and_lines():
    entries = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
               + SPEC["per_layer"])
    names = [e["name"] for e in entries]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in SPEC[kind]]
        assert len(ns) == len(set(ns)), kind
    assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200
        assert "\n" not in c["why"] and "\t" not in c["why"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                    if w["name"] == cell)
    assert c.traffic["kind"] in ("progressive", "train")
    assert c.checks["limits"]
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in reported


def test_every_per_layer_metric_names_cells_that_report_its_target():
    cells = {c: {m["name"] for m in load_cell(c).end_to_end} for c in CELLS}
    for m in SPEC["per_layer"]:
        for c in m["workloads"]:
            assert m["moves"] in cells[c], (m["name"], c)


@pytest.mark.parametrize("kernel", ["kernel_a", "kernel_b", "kernel_c",
                                    "kernel_d", "kernel_e", "kernel_f"])
def test_work_files(kernel):
    w = load_module("work", kernel)
    assert w.KERNELS and w.ANCHOR and set(w.ANCHOR) <= set(w.KERNELS)
    assert callable(w.work)


def test_a_new_config_mix_kind_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix of a new traffic
    kind, a metric and a cell as new files and new entries, and load
    them: no file that was there is changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    cfg = json.loads((ROOT / "benchmark/configs/glass_720p.json").read_text())
    cfg.update(name="glass_360p")
    cfg["render"].update(width=640, height=360)
    b = tmp_path / "benchmark"
    (b / "configs/glass_360p.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/progressive.json").read_text())
    mix.update(calls_per_chunk=16, kind="bursts")
    (b / "traffic/bursts.json").write_text(json.dumps(mix))
    (b / "kinds/bursts.py").write_text(
        (b / "kinds/progressive.py").read_text())
    (b / "checks/glass_360p.bursts.json").write_text(json.dumps(
        {"frames_sampled": 1, "colour_atol": 1e-3,
         "limits": {"pixels_off": 0.01}}))
    (b / "metrics/frames.bursts.py").write_text(
        "def read(ctx):\n    return float(ctx.window.calls)\n")
    spec["configs"].append({"name": "glass_360p", "source": "x",
                            "file": "benchmark/configs/glass_360p.json",
                            "reduced": ["width", "height"], "why": "x"})
    spec["workloads"].append({"name": "glass_360p.bursts",
                              "config": "glass_360p", "traffic": "bursts",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "frames.bursts", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver", "moves": "frame_mrays_s",
                              "workloads": ["glass_360p.bursts"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("frame_mrays_s", "frame_ms_p95"):
            m["workloads"].append("glass_360p.bursts")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("glass_360p.bursts", root=tmp_path)
    assert cell.render["width"] == 640 and cell.traffic["calls_per_chunk"] == 16
    kind = load_module("kinds", cell.traffic["kind"], root=tmp_path)
    assert issubclass(kind.Session, window.Session)
    assert kind.draw(cell, torch.Generator().manual_seed(1), "cpu", {},
                     None)["check_fractions"]
    assert [m["name"] for m in cell.per_layer] == ["frames.bursts"]
    assert load_module("metrics", "frames.bursts", root=tmp_path).read(
        type("Ctx", (), {"window": type("W", (), {"calls": 3})})) == 3.0
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("cell", CELLS)
def test_inputs_follow_the_seed(cell):
    c = load_cell(cell)
    c.config["render"].update(width=8, height=4)
    c.config["env"] = dict(c.config["env"], width=8, height=4)
    a = make_inputs(c, 2 ** 31 + 5, torch.device("cpu"))
    b = make_inputs(c, 2 ** 31 + 5, torch.device("cpu"))
    d = make_inputs(c, 7, torch.device("cpu"))
    assert torch.equal(a.tex, b.tex) and not torch.equal(a.tex, d.tex)
    assert a.tex.shape == d.tex.shape and a.opts == d.opts
    if c.traffic["kind"] == "progressive":
        assert a.check_fractions == b.check_fractions
    else:
        assert all(torch.equal(a.params0[k], b.params0[k]) for k in a.params0)
        assert a.frame0 == b.frame0
        assert {k: v.shape for k, v in a.params0.items()} == {
            k: v.shape for k, v in d.params0.items()}


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def _printed_result(p) -> bool:
    return any(line.startswith("{") for line in p.stdout.splitlines())


def test_a_run_without_a_card_fails():
    p = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and not _printed_result(p)


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and not _printed_result(p)
