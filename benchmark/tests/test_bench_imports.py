"""No module the benchmark runs, and no module of the program, imports JAX
or the JAX package; the reference imports nothing of the program.

Imports are read from each file's syntax tree. Module names are compared
by their top-level name (before the first dot) as a whole word: the
program's name, ``cpuperformanceraytracer_tpu_torch``, begins with the
JAX package's, ``cpuperformanceraytracer_tpu``.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
PROGRAM = "cpuperformanceraytracer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "cpuperformanceraytracer_tpu"}


def top_level_imports(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


BENCH_FILES = sorted(BENCH.rglob("*.py"))
PROGRAM_FILES = sorted((ROOT / PROGRAM).rglob("*.py"))


def _id(p: Path) -> str:
    return str(p.relative_to(ROOT))


def test_the_files_are_found():
    assert len(BENCH_FILES) > 20 and len(PROGRAM_FILES) > 40


@pytest.mark.parametrize("path", BENCH_FILES + PROGRAM_FILES, ids=_id)
def test_no_jax_import(path):
    bad = top_level_imports(path) & FORBIDDEN
    assert not bad, f"{_id(path)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=_id)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names
    assert names <= {"__future__", "math", "typing", "torch", "numpy",
                     "benchmark"}, names


@pytest.mark.parametrize(
    "path", [p for p in BENCH_FILES if "tests" not in p.parts], ids=_id)
def test_only_the_adapter_imports_the_program(path):
    """The benchmark reaches the program through ``harness/port.py``
    alone; the yardstick (traffic, counts, reference, comparison) does
    not depend on it."""
    if path == BENCH / "harness" / "port.py":
        assert PROGRAM in top_level_imports(path)
    else:
        assert PROGRAM not in top_level_imports(path)


def test_the_check_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom cpuperformanceraytracer_tpu"
                 ".render import frame\nimport cpuperformanceraytracer_tpu_"
                 "torch\n")
    assert top_level_imports(f) & FORBIDDEN == {
        "jax", "cpuperformanceraytracer_tpu"}
