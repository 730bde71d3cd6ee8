"""The comparison that decides ``correct``, at a size a test run holds.

A whole run of each cell is driven on the CPU (the look for a card
skipped, the program's plain-PyTorch kernels in place of the CUDA ones,
a small image): it comes out correct as it stands, and not correct with
the timed path broken underneath in each way the cell can break: a call
that leaves its state unchanged, half of the batch left out, an answer
altered where it is produced, a gradient at the wrong scale, and a
checkpoint saved stale, under the wrong frame, not at all, or rounded to
bfloat16. The lower-precision control (the reference in bfloat16 in the
program's place) fails the cells' limits. A training cell of several
samples a step (BASELINE config 4's settings) is added to a copy of the
benchmark as new files and entries alone, and runs the same way.
"""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import check, main, port, spec, window
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_cell, load_module, load_spec
from cpuperformanceraytracer_tpu_torch.diff import grad, inverse
from cpuperformanceraytracer_tpu_torch.io import checkpoint
from cpuperformanceraytracer_tpu_torch.render import driver
from planted import backward_scaled

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in load_spec()["workloads"]]
PROGRESSIVE = [c for c in CELLS if load_cell(c).traffic["kind"] == "progressive"]
TRAIN = [c for c in CELLS if load_cell(c).traffic["kind"] == "train"]
CHECKPOINTED = [c for c in CELLS
                if load_cell(c).traffic["kind"] == "checkpointed"]


def small_cell(name, root=ROOT):
    """The cell (of the benchmark at ``root``) at 32x16, 2 bounces, a 16x8
    env map, and two samples where it has several; a save every 8 frames
    where it saves."""
    cell = load_cell(name, root=root)
    render = cell.config["render"]
    render.update(width=32, height=16, bounces=2,
                  spp=min(render["spp"], 2))
    cell.config["env"] = dict(cell.config["env"], width=16, height=8)
    if "save_every" in cell.traffic:
        cell.traffic.update(save_every=8, calls_per_chunk=8, held_calls=2,
                            trace_calls=8)
    return cell


class HostClock:
    """The host's clock in place of CUDA events, where there is no card."""

    def mark(self):
        return time.perf_counter()

    def wait(self, mark):
        pass

    def sync(self):
        pass

    def ms(self, a, b):
        return (b - a) * 1e3


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    """A run at the small size, the program's plain-PyTorch kernels in
    place of its CUDA ones, timed by the host clock, its saves under a
    directory of its own."""
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(main, "load_cell", small_cell)
    monkeypatch.setattr(port, "BACKEND", "torch")
    monkeypatch.setattr(window, "Clock", HostClock)


def _run(cell, seed=2 ** 31 + 11):
    result, _ = main.run(cell, seed, 0.05, False, CPU, time.perf_counter(),
                         log=lambda msg: None)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, on_cpu):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def _unchanged_frame(self):
    self.frame += 1


def _half_frame(self):
    keep = self.local[:, self.local.shape[1] // 2:].clone()
    self.frame_fn(self.texture, self.frame, self.local)
    self.local[:, self.local.shape[1] // 2:] = keep
    self.frame += 1


def _next_frame(self):
    from cpuperformanceraytracer_tpu_torch.render.frame import frame_blend

    self.frame_fn(self.texture, self.frame + 1, self.local,
                  frame_blend(self.frame))
    self.frame += 1


@pytest.mark.parametrize("cell", PROGRESSIVE + CHECKPOINTED)
@pytest.mark.parametrize("fault", [_unchanged_frame, _half_frame, _next_frame],
                         ids=["unchanged", "half_batch", "wrong_frame"])
def test_a_broken_frame_is_not_correct(cell, fault, monkeypatch, on_cpu):
    monkeypatch.setattr(driver.OfflineRenderer, "step", fault)
    assert not _run(cell)["correct"]


def _stale_save(self, path):
    """The accumulator of the save before (zeros before the first) under
    the new frame."""
    r = self.renderer
    prev = getattr(self, "_prev", torch.zeros_like(r.accum))
    checkpoint.save_checkpoint(path, prev, r.frame, r.cfg)
    self._prev = r.accum.clone()


def _wrong_frame_save(self, path):
    r = self.renderer
    checkpoint.save_checkpoint(path, r.accum, r.frame + 1, r.cfg)


def _missing_save(self, path):
    pass


def _bfloat16_save(self, path):
    r = self.renderer
    checkpoint.save_checkpoint(path, r.accum.to(torch.bfloat16).float(),
                               r.frame, r.cfg)


@pytest.mark.parametrize("cell", CHECKPOINTED)
@pytest.mark.parametrize("fault", [_stale_save, _wrong_frame_save,
                                   _missing_save, _bfloat16_save],
                         ids=["stale", "wrong_frame", "missing", "bfloat16"])
def test_a_broken_save_is_not_correct(cell, fault, monkeypatch, on_cpu):
    monkeypatch.setattr(port.Progressive, "save", fault)
    result = _run(cell)
    assert not result["correct"], result["checks"]
    assert result["checks"]["saves_off"]["value"] > 0
    assert result["checks"]["pixels_off"]["value"] == 0


def _half_loss(a, b):
    h = a.shape[1] // 2
    return ((a[:, :h] - b[:, :h]) ** 2).mean()


_ADAM_STEP = torch.optim.Adam.step


def _step_leaving_albedos(self, closure=None):
    """Adam's step with the material albedos (the first leaf) left as they
    were: a material gradient lost on the way to the optimizer."""
    p = self.param_groups[0]["params"][0]
    keep = p.detach().clone()
    out = _ADAM_STEP(self, closure)
    with torch.no_grad():
        p.copy_(keep)
    return out


def _second_sample_detached():
    """``diff.grad.env_color_reference`` with every second call's colour
    (the second sample of a two-sample frame) cut from the gradient."""
    env_color = grad.env_color_reference
    calls = [0]

    def color(*args, **kwargs):
        out, idx = env_color(*args, **kwargs)
        calls[0] += 1
        return (out.detach() if calls[0] % 2 == 0 else out), idx
    return color


def _plant(fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(inverse, "image_loss", _half_loss)
    elif fault == "one_leaf_unmoved":
        monkeypatch.setattr(torch.optim.Adam, "step", _step_leaving_albedos)
    elif fault == "second_sample_detached":
        monkeypatch.setattr(grad, "env_color_reference",
                            _second_sample_detached())
    else:
        # the plain route both a training step and the gradient's check
        # take on the CPU
        factor = {"grad_scaled": 2.0, "grad_halved": 0.5}[fault]
        monkeypatch.setattr(grad, "render_frame_plain", backward_scaled(
            grad.render_frame_plain, factor))


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "one_leaf_unmoved", "grad_scaled",
                                   "grad_halved"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch, on_cpu):
    _plant(fault, monkeypatch)
    result = _run(cell)
    assert not result["correct"], result["checks"]
    if fault.startswith("grad_"):
        # the forward is as it was: the gradient's own check fails it
        checks = result["checks"]
        assert checks["loss_gap"]["value"] <= checks["loss_gap"]["limit"]
        assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", PROGRESSIVE)
def test_the_control_fails_a_frame(cell):
    c = small_cell(cell)
    inputs = make_inputs(c, 5, CPU)
    got = load_module("kinds", "progressive").variants(inputs, c.checks,
                                                       [0, 3])
    limit = c.checks["limits"]["pixels_off"]
    assert all(v > limit for v in got.values()), got


@pytest.mark.parametrize("cell", CHECKPOINTED)
def test_the_control_fails_a_save(cell, monkeypatch, tmp_path):
    """The sound reference save reads 0; the control and each planted
    fault fail one of the cell's numbers."""
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    c = small_cell(cell)
    inputs = make_inputs(c, 5, CPU)
    got = load_module("kinds", "checkpointed").control(inputs, c)
    limits = c.checks["limits"]
    assert got.pop("sound") == {"saves_off": 0.0}
    assert {k for k, v in got.items() if "saves_off" in v} == {
        "stale", "wrong_frame", "missing", "control"}
    for variant, nums in got.items():
        assert any(v > limits[k] for k, v in nums.items()), (variant, nums)


@pytest.mark.parametrize("cell", TRAIN)
def test_the_control_fails_a_step(cell):
    c = small_cell(cell)
    inputs = make_inputs(c, 5, CPU)
    got = load_module("kinds", "train").variants(inputs, c.traffic)
    limits = c.checks["limits"]
    for variant, nums in got.items():
        assert any(v > limits[k] for k, v in nums.items()), (variant, nums)


def test_the_change_gap_is_the_worst_moving_leaf():
    start = {"a": torch.zeros(4), "b": torch.zeros(2), "c": torch.zeros(3)}
    inputs = type("Inputs", (), {"params0": start})
    ref = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-4},
           "params": {"a": torch.ones(4), "b": torch.ones(2),
                      "c": torch.ones(3)}}
    prog = {"losses": [1.0], "params": {"a": torch.ones(4),
                                        "b": 0.5 * torch.ones(2),
                                        "c": torch.zeros(3)}}
    got = check.compare_train(inputs, prog, ref)
    # root mean squares 0.5, 1.41 and 5.8e-5: c moves by round-off alone
    # in the reference and is left out
    assert got["leaves_compared"] == ["a", "b"]
    assert got["change_gap"] == pytest.approx(0.5)
    assert got["leaf_change_gaps"]["c"] == pytest.approx(1.0)


def test_the_grad_gap_is_the_worst_moving_leaf():
    start = {"a": torch.zeros(4), "b": torch.zeros(2), "c": torch.zeros(3)}
    inputs = type("Inputs", (), {"params0": start})
    grads = {"a": torch.full((4,), 0.5), "b": torch.full((2,), 2 ** 0.5),
             "c": torch.full((3,), 1e-4 / 3 ** 0.5)}
    ref = {"losses": [1.0], "grads": grads,
           "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-4}}
    off = torch.tensor([0.1, 0.0])
    prog = {"losses": [1.0], "grads": {"a": 2.0 * grads["a"],
                                       "b": grads["b"] + off,
                                       "c": torch.zeros(3)}}
    got = check.compare_train(inputs, prog, ref)
    # ||2a - a|| / ||a|| = 1; ||(0.1, 0)|| / 2 = 0.05; c moves by
    # round-off alone in the reference and is left out
    assert got["grad_gap"] == pytest.approx(1.0)
    assert got["leaf_grad_gaps"]["b"] == pytest.approx(0.05)
    assert got["leaf_grad_gaps"]["c"] == pytest.approx(1.0)
    prog["grads"]["b"] = torch.tensor([float("nan"), 0.0])
    assert check.compare_train(inputs, prog, ref)["grad_gap"] == float("inf")


def test_the_grad_gap_leaves_out_a_turned_path_and_a_swinging_leaf():
    """Six elements that differ most are left out of a leaf's gap; a leaf
    whose float64 gradient swings from the float32 one is left out of
    ``grad_gap``, and the steadiest stays where every leaf swings."""
    start = {"a": torch.zeros(40), "b": torch.zeros(40)}
    inputs = type("Inputs", (), {"params0": start})
    grads = {"a": torch.ones(40), "b": torch.ones(40)}
    ref = {"losses": [1.0], "grads": grads,
           "grad_norms": {"a": 40 ** 0.5, "b": 40 ** 0.5},
           "grads_f64": {"a": grads["a"].double(),
                         "b": grads["b"].double()}}
    turned = torch.ones(40)
    turned[:6] = 100.0
    prog = {"losses": [1.0], "grads": {"a": turned, "b": 1.01 * grads["b"]}}
    got = check.compare_train(inputs, prog, ref)
    assert got["leaf_grad_gaps"]["a"] == 0.0
    assert got["grad_gap"] == pytest.approx(0.01)
    ref["grads_f64"]["b"] = 1.1 * grads["b"].double()
    got = check.compare_train(inputs, prog, ref)
    assert got["grad_leaves_compared"] == ["a"] and got["grad_gap"] == 0.0
    ref["grads_f64"]["a"] = 1.2 * grads["a"].double()
    got = check.compare_train(inputs, prog, ref)
    assert got["grad_leaves_compared"] == ["b"]
    assert got["grad_gap"] == pytest.approx(0.01)
    prog["grads"]["b"][0] = float("nan")
    assert check.compare_train(inputs, prog, ref)["grad_gap"] == float("inf")


def test_pixels_off_counts_nan_as_off():
    pre = torch.zeros(3, 2, 2)
    post = torch.full((3, 2, 2), float("nan"))
    assert check.pixels_off(pre, post, torch.zeros(3, 2, 2), 0, 1e-3) == 1.0


@pytest.fixture
def config4(tmp_path, on_cpu, monkeypatch):
    """A copy of the benchmark with BASELINE config 4's cell added as new
    files and new entries alone: a configuration with the settings of
    the port's ``inverse_env_demo`` (256x144, 3 bounces, the glass scene,
    a 512x256 env), a mix of kind ``train`` at two counter-RNG samples a
    step and lr 0.02, its checks (the train cells' limits) and its cell;
    runs load the cell from the copy, at the small size. Yields the
    copy's root; on the way out no file of the benchmark's that was there
    has changed (``BENCHMARK.json`` gains entries)."""
    root = tmp_path / "copy"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    b = root / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    cfg = json.loads((b / "configs/glass_720p.json").read_text())
    cfg.update(name="env_inverse_144p")
    cfg["render"].update(width=256, height=144, bounces=3, spp=2,
                         rng="counter")
    (b / "configs/env_inverse_144p.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic/train.json").read_text())
    mix.update(render={"rng": "counter", "spp": 2}, lr=0.02)
    (b / "traffic/train_spp2.json").write_text(json.dumps(mix))
    checks = json.loads((b / "checks/glass_720p.train.json").read_text())
    (b / "checks/env_inverse_144p.train_spp2.json").write_text(
        json.dumps(checks))
    spec_ = json.loads((root / "BENCHMARK.json").read_text())
    spec_["configs"].append({"name": "env_inverse_144p", "source": "x",
                             "file": "benchmark/configs/env_inverse_144p.json",
                             "reduced": [], "why": "x"})
    spec_["workloads"].append({"name": "env_inverse_144p.train_spp2",
                               "config": "env_inverse_144p",
                               "traffic": "train_spp2", "chips": 1,
                               "why": "x"})
    for m in spec_["end_to_end"] + spec_["per_layer"]:
        if "glass_720p.train" in m.get("workloads", []):
            m["workloads"].append("env_inverse_144p.train_spp2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec_))
    monkeypatch.setattr(main, "load_cell",
                        lambda name: small_cell(name, root=root))
    yield root
    assert all(p.read_bytes() == data for p, data in before.items())


def test_a_config4_cell_needs_only_new_files(config4):
    cell = load_cell("env_inverse_144p.train_spp2", root=config4)
    assert cell.render["spp"] == 2 and cell.traffic["lr"] == 0.02
    assert set(cell.checks["limits"]) == set(
        load_module("kinds", cell.traffic["kind"], root=config4).COMPARES)
    result = _run("env_inverse_144p.train_spp2")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_mrays_s", "setup_s"}


@pytest.mark.parametrize("fault", ["grad_scaled", "second_sample_detached",
                                   "unchanged"])
def test_a_broken_config4_step_is_not_correct(fault, config4, monkeypatch):
    _plant(fault, monkeypatch)
    result = _run("env_inverse_144p.train_spp2")
    assert not result["correct"], result["checks"]
