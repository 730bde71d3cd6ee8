"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one its entry in ``configs`` gives;
the mix is ``benchmark/traffic/<traffic>.json``; the cell's correctness
limits are ``benchmark/checks/<cell>.json``; a per-layer metric is read
by ``benchmark/metrics/<metric>.py`` and a kernel's work counted by
``benchmark/work/<kernel>.py``. Nothing here names a cell, a mix or a
metric: a new one is a new entry and new files.

A configuration may give the program's mesh, ``"mesh": {"px": p, "spp":
s}`` (rows over "px", samples over "spp", as the program's
``parallel/mesh.py`` names its axes); its cells then run as a world of
p·s ranks, one card a rank (``harness/world.py``), and ask for p·s chips.
A configuration without one is a world of one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list
    chips: int = 1
    mesh: tuple = (1, 1)        # (px, spp)

    @property
    def render(self) -> dict:
        """The config's render settings with the mix's overrides."""
        return {**self.config["render"], **self.traffic.get("render", {})}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name`` with its files, and the metrics it
    reports: the end-to-end ones whose ``workloads`` (when given) list it,
    and the per-layer ones whose ``workloads`` list it or, without that
    key, that move an end-to-end metric the cell reports."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    mesh = world_shape(name, w["chips"], config)
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    checks = load_json(root / "benchmark" / "checks" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, config, traffic, checks, e2e, layer, w["chips"], mesh)


def world_shape(name: str, chips: int, config: dict) -> tuple:
    """(px, spp) of the configuration's mesh, (1, 1) without one; raises
    where the cell ``name`` asks for another number of chips than the
    mesh has ranks, before anything runs."""
    mesh = config.get("mesh", {})
    if set(mesh) - {"px", "spp"} or not all(
            isinstance(v, int) and v >= 1 for v in mesh.values()):
        raise ValueError(f"the mesh of {config.get('name')!r}, {mesh}: want "
                         '{"px": p, "spp": s}, whole numbers from 1')
    shape = (mesh.get("px", 1), mesh.get("spp", 1))
    if chips != shape[0] * shape[1]:
        raise ValueError(
            f"workload {name!r} asks for {chips} chip(s), but its "
            f"configuration's mesh (px, spp) = {shape} is a world of "
            f"{shape[0] * shape[1]} rank(s), one chip a rank")
    return shape


def load_module(kind: str, name: str, root: Path = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (its file name may hold
    dots, so it is loaded from its path)."""
    path = root / "benchmark" / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    if mod_spec is None or not path.exists():
        raise FileNotFoundError(f"{path} (the {kind} file of {name!r})")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
