"""The comparison that decides ``correct``, at a size a test run holds.

A whole run of each cell is driven on the CPU (the look for a card
skipped, the program's plain-PyTorch kernels in place of the CUDA ones,
a small image): it comes out correct as it stands, and not correct with
the timed path broken underneath in each way the cell can break: a call
that leaves its state unchanged, half of the batch left out, an answer
altered where it is produced, and a checkpoint saved stale, under the
wrong frame, not at all, or rounded to bfloat16. The lower-precision control (the
reference in bfloat16 in the program's place) fails the cells' limits.
"""

import time

import pytest
import torch

from benchmark.harness import check, main, port, spec, window
from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_cell, load_module, load_spec
from cpuperformanceraytracer_tpu_torch.diff import inverse
from cpuperformanceraytracer_tpu_torch.io import checkpoint
from cpuperformanceraytracer_tpu_torch.render import driver

CPU = torch.device("cpu")
CELLS = [w["name"] for w in load_spec()["workloads"]]
PROGRESSIVE = [c for c in CELLS if load_cell(c).traffic["kind"] == "progressive"]
TRAIN = [c for c in CELLS if load_cell(c).traffic["kind"] == "train"]
CHECKPOINTED = [c for c in CELLS
                if load_cell(c).traffic["kind"] == "checkpointed"]


def small_cell(name):
    """The cell at 32x16, 2 bounces, a 16x8 env map, and two samples
    where it has several; a save every 8 frames where it saves."""
    cell = load_cell(name)
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


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "one_leaf_unmoved"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch, on_cpu):
    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(inverse, "image_loss", _half_loss)
    else:
        monkeypatch.setattr(torch.optim.Adam, "step", _step_leaving_albedos)
    result = _run(cell)
    assert not result["correct"], result["checks"]


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


def test_pixels_off_counts_nan_as_off():
    pre = torch.zeros(3, 2, 2)
    post = torch.full((3, 2, 2), float("nan"))
    assert check.pixels_off(pre, post, torch.zeros(3, 2, 2), 0, 1e-3) == 1.0
