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

import numpy as np
import pytest
import torch

from benchmark.harness import window
from benchmark.harness.inputs import gradient_sky, make_inputs
from benchmark.harness.spec import (
    load_cell,
    load_module,
    load_spec,
    world_shape,
)

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
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
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
    assert four_chip_cells_admitted(SPEC["workloads"])


def four_chip_cells_admitted(workloads) -> bool:
    """At most a quarter of the cells, rounded down, ask for 4 chips; one
    always may."""
    fours = sum(w["chips"] == 4 for w in workloads)
    return fours <= max(1, len(workloads) // 4)


@pytest.mark.parametrize("cells, fours, admitted", [
    (6, 1, True), (7, 1, True), (7, 2, False), (8, 2, True), (8, 3, False),
    (3, 1, True), (3, 2, False)])
def test_four_chip_cells_up_to_the_cap(cells, fours, admitted):
    workloads = [{"chips": 4 if i < fours else 1} for i in range(cells)]
    assert four_chip_cells_admitted(workloads) == admitted


@pytest.mark.parametrize("chips, mesh, shape", [
    (1, None, (1, 1)), (4, {"px": 4}, (4, 1)), (4, {"px": 2, "spp": 2},
                                                 (2, 2)),
    (4, None, None), (2, {"px": 4}, None), (1, {"px": 2}, None),
    (4, {"px": 4, "rows": 1}, None), (4, {"px": 4.0}, None)])
def test_a_cell_asks_for_as_many_chips_as_its_mesh_has_ranks(chips, mesh,
                                                             shape):
    """``chips`` = px · spp of the configuration's mesh (a world of one
    without one); any other count, or a mesh of other axes, is refused
    before anything runs."""
    config = {"name": "c"} if mesh is None else {"name": "c", "mesh": mesh}
    if shape is None:
        with pytest.raises(ValueError):
            world_shape("c.mix", chips, config)
    else:
        assert world_shape("c.mix", chips, config) == shape


def test_a_run_of_a_cell_whose_chips_are_not_its_mesh_is_refused(tmp_path):
    """A copy of the benchmark whose 4K configuration gains the mesh
    {"px": 4}: its cells, each on one chip, no longer load."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    path = tmp_path / "benchmark/configs/offline_4k.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, mesh={"px": 4})))
    with pytest.raises(ValueError, match="asks for 1 chip"):
        load_cell("offline_4k.progressive", root=tmp_path)
    assert load_cell("glass_720p.progressive", root=tmp_path).mesh == (1, 1)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                    if w["name"] == cell)
    assert load_module("kinds", c.traffic["kind"]).COMPARES
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


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_a_config_file_states_what_was_cut(config):
    """A configuration's file holds its entry's source and ``reduced``,
    and each reduced key beside what it was cut from."""
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in cfg["reduced"]:
        assert key in cfg and cfg["reductions"][key]


def test_offline_4k_is_the_glass_scene_at_4k():
    """Config 5 renders the glass scene, its camera and its env settings
    as ``glass_720p`` does, at 3840x2160 with the counter RNG."""
    glass = json.loads((ROOT / "benchmark/configs/glass_720p.json")
                       .read_text())
    cfg = json.loads((ROOT / "benchmark/configs/offline_4k.json")
                     .read_text())
    assert cfg["scene"] == glass["scene"] and cfg["env"] == glass["env"]
    r = cfg["render"]
    assert {k for k in glass["render"] if r[k] != glass["render"][k]} == {
        "width", "height", "rng"}
    assert (r["width"], r["height"], r["spp"], r["bounces"], r["rng"],
            r["roulette"]) == (3840, 2160, 1, 8, "counter", "v4_quirk")


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in SPEC["workloads"]}))
def test_a_mix_names_a_kind_with_its_hooks(mix):
    t = json.loads((ROOT / f"benchmark/traffic/{mix}.json").read_text())
    kind = load_module("kinds", t["kind"])
    assert issubclass(kind.Session, window.Session)
    assert all(callable(getattr(kind, f))
               for f in ("draw", "launches", "control"))
    assert all(t[k] >= 1 for k in ("calls_per_chunk", "chunks_in_flight",
                                   "held_calls", "trace_calls"))


def test_the_checkpointed_mix_saves_at_each_chunks_end():
    """Each chunk of the window ends with a save, so the window, which
    ends only at a chunk's end, holds whole intervals; the stream-held
    calls after it (and the one before them) make no save, since a save
    waits for the device and would drain the held stream; the traced
    calls hold one interval and its save."""
    t = json.loads((ROOT / "benchmark/traffic/checkpointed.json")
                   .read_text())
    assert t["calls_per_chunk"] == t["save_every"] == t["trace_calls"]
    assert t["held_calls"] + 1 < t["save_every"]
    assert t["min_saves"] >= 2 and t["save_wait_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_checks_limit_every_number_the_kind_compares(cell):
    c = load_cell(cell)
    numbers = load_module("kinds", c.traffic["kind"]).COMPARES
    assert set(c.checks["limits"]) == set(numbers)
    if c.traffic["kind"] == "checkpointed":
        # a save is a copy: compared exactly, in the format's version 1
        assert c.checks["limits"]["saves_off"] == 0
        assert c.checks["format_version"] == 1


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
    # a mix that fixes the sun renders the same env map for every seed
    fixed = "env_sun" in c.traffic
    assert torch.equal(a.tex, b.tex) and torch.equal(a.tex, d.tex) == fixed
    assert a.tex.shape == d.tex.shape and a.opts == d.opts
    if c.traffic["kind"] == "progressive":
        assert a.check_fractions == b.check_fractions
    elif c.traffic["kind"] == "checkpointed":
        t = c.traffic
        assert a.check_frames == b.check_frames
        assert len(a.check_frames) == len(d.check_frames)
        assert all(0 < f < t["min_saves"] * t["save_every"]
                   for f in a.check_frames + d.check_frames)
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


def test_a_fixed_sun_is_where_the_mix_puts_it():
    """``env_sun`` = (u, v) puts the sun's brightest texel there for every
    seed, after the draw that would have placed it, so what is drawn next
    does not move; the checkpointed mix's sun is where the program's
    ``gradient_sky`` puts it with its seed 0."""
    gen, same = (torch.Generator().manual_seed(3) for _ in range(2))
    tex = gradient_sky(64, 32, gen, "cpu", (0.25, 0.75))
    row, col = divmod(int(tex[0].argmax()), 64)
    assert (row, col) == (round(0.75 * 31), round(0.25 * 63))
    torch.rand(2, generator=same)
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=same))
    rs = np.random.RandomState(0)
    sun = json.loads((ROOT / "benchmark/traffic/checkpointed.json")
                     .read_text())["env_sun"]
    assert sun == [rs.uniform(0.2, 0.8), rs.uniform(0.5, 0.9)]


def test_a_run_without_a_card_fails():
    p = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and not _printed_result(p)


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and not _printed_result(p)
