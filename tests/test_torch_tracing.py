"""The port's tracing (``utils/profiling``) on the CPU, with the plain-torch
backend at 32x16 and 1 bounce: off by default, when the hot path makes
no annotation; on, when a frame is ``driver.frame`` around its
``frame.render`` and ``frame.resolve`` spans and a training step the
phases ``step.render``, ``step.loss``, ``step.backward`` and
``step.adam`` in that order; ``trace(log_dir)`` writes the Chrome trace
and the counters. The device events, lane counters and graph replays
are held on the card by ``tests/test_torch_cuda.py``.
"""

import json

import pytest
import torch

from torch_port_helpers import NOTHING_TRACED  # one intra-op thread too
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff.grad import render_for_params
from cpuperformanceraytracer_tpu_torch.diff.inverse import (
    InverseProblem,
    make_train_step_k,
)
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array
from cpuperformanceraytracer_tpu_torch.utils import profiling

SPANS = ("driver.frame", "frame.render", "frame.resolve", "dispatch",
         "dispatch.replay", "dispatch.losses")
PHASES = ("step.render", "step.loss", "step.backward", "step.adam")
SIZE = dict(width=32, height=16, bounces=1, warmup_frames=0, num_frames=2,
            backend="torch")


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and nothing recorded."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _texture():
    return texture_from_array(gradient_sky(16, 8))


def _renderer(**kw) -> OfflineRenderer:
    return OfflineRenderer(RenderConfig(**SIZE, **kw), texture=_texture(),
                           silent=True)


def _train_step_k(k: int = 2):
    """(step_k, params): K Adam steps over the albedos of the glass
    scene, a fresh counter-RNG sample a step."""
    cfg = RenderConfig(**SIZE, rng="counter")
    scene, cam = scene_by_name(cfg.scene)
    tex = _texture()
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    a = scene.materials.albedo
    params = {"albedo": (torch.stack([a.x, a.y, a.z], -1) + 0.05)
              .requires_grad_()}
    opt = torch.optim.Adam(list(params.values()), lr=0.01)
    step_k = make_train_step_k(InverseProblem(scene, cam, tex, cfg, target),
                               opt, k, resample_frames=True)
    return step_k, params


def _events(fn) -> list:
    """[(name, start us, end us)] of a CPU profiler run of ``fn()``, by
    start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()), key=lambda e: e[1])


def _inside(outer, inner) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_by_default_costs_a_flag_check():
    assert not profiling.enabled()
    assert profiling.span("driver.frame") is profiling.span("dispatch")
    assert profiling.phases("cpu").phase("step.loss") is profiling.span("x")
    assert profiling.lane_counter("kernel_a", "cpu") is None
    assert profiling.read() == NOTHING_TRACED


def test_off_the_hot_path_makes_no_annotation():
    r = _renderer(rng="wang")
    step_k, params = _train_step_k()
    names = {e[0] for e in _events(lambda: (r.step(), r.step(),
                                            step_k(params, 1)))}
    assert not names & set(SPANS + PHASES)
    assert not [n for n in names if n.startswith(("driver.", "frame.",
                                                  "step.", "dispatch"))]
    assert profiling.read() == NOTHING_TRACED


@pytest.mark.parametrize("route", [dict(rng="wang"),
                                   dict(rng="counter", spp=2)],
                         ids=["a_b", "a_e_f"])
def test_on_a_frame_holds_its_render_and_resolve(route):
    r = _renderer(**route)
    profiling.enable()
    events = _events(lambda: (r.step(), r.step()))
    frames = [e for e in events if e[0] == "driver.frame"]
    assert len(frames) == 2
    spp = route.get("spp", 1)
    for frame in frames:
        inner = [e[0] for e in events if e[0].startswith("frame.")
                 and _inside(frame, e)]
        # A, then B; or A and E a sample, then F
        want = (["frame.render", "frame.resolve"] * spp
                + ["frame.resolve"] * (spp > 1))
        assert inner == want


def test_on_a_step_is_four_phases_in_order():
    step_k, params = _train_step_k(k=2)
    profiling.enable()
    events = [e for e in _events(lambda: step_k(params, 1))
              if e[0] in PHASES]
    assert [e[0] for e in events] == list(PHASES) * 2
    # back to back: each phase starts after the one before it ended
    assert all(a[2] <= b[1] for a, b in zip(events, events[1:]))
    # no device, so no event and no counter
    assert profiling.read() == NOTHING_TRACED


def test_trace_writes_the_trace_and_the_counters(tmp_path):
    r = _renderer(rng="wang")
    with profiling.trace(str(tmp_path / "t")) as d:
        assert profiling.enabled()
        r.step()
    assert d == str(tmp_path / "t") and not profiling.enabled()
    events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"driver.frame", "frame.render", "frame.resolve"} <= names
    counters = json.loads((tmp_path / "t" / profiling.COUNTERS_FILE)
                          .read_text())
    assert counters == NOTHING_TRACED


def test_enable_disable_and_a_trace_inside_tracing(tmp_path):
    profiling.enable()
    assert profiling.enabled()
    # a span is recorded while a profiler runs, and costs nothing without
    assert profiling.span("a") is profiling.span("b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("a") is not profiling.span("a")
    # a CPU device has no lane counter, tracing or not
    assert profiling.lane_counter("kernel_a", torch.device("cpu")) is None
    with profiling.trace(str(tmp_path)):
        pass
    assert profiling.enabled()          # a trace leaves tracing as it found it
    profiling.disable()
    assert not profiling.enabled()


def test_replays_count_the_launches_their_capture_made():
    """A graph's replays count what its capture launched, apart from the
    wrapper's own count of the launches it made."""
    def fake_kernel():
        pass

    fake_kernel.launches = 5
    with profiling.capturing() as made:
        pass                            # a capture that launched nothing
    assert made.launches == {} and made.phases == []
    made.launches = {fake_kernel: 3}
    for _ in range(4):
        profiling.replayed(made)
    assert profiling.replayed_launches()["fake_kernel"] == 4 * 3
    assert fake_kernel.launches == 5 and made.replays == 4 and made.replayed
    profiling.reset()
    assert not made.replayed and made.replays == 4
