"""The traced window's arithmetic on a trace made by hand: the device's
busy seconds, the time by kernel, the idle gaps named by what the host
was doing, and the per-layer readers built on them."""

import json

import pytest

from benchmark.harness.spec import load_module
from benchmark.harness.trace import Trace, read_chrome_trace, span_s
from benchmark.harness.window import Window, percentile
from benchmark.work.common import bound_ms

EVENTS = [
    # host: a call that launches two kernels, then a synchronise
    {"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 0,
     "dur": 40},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5,
     "dur": 5},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
     "ts": 45, "dur": 100},
    # device: A 10-30, B 32-40 (a 2 us gap), then A again 60-100
    {"ph": "X", "cat": "kernel", "name": "render_planes_kernel(x)", "ts": 10,
     "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "env_accumulate_kernel(y)", "ts": 32,
     "dur": 8},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 35,
     "dur": 2},
    {"ph": "X", "cat": "kernel", "name": "render_planes_kernel(x)", "ts": 60,
     "dur": 40},
    {"ph": "i", "cat": "kernel", "name": "ignored", "ts": 0},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    ops, host = read_chrome_trace(path)
    return Trace(calls=2, window_s=span_s(ops), ops=ops, host=host)


def test_busy_is_the_union_of_device_ops(trace):
    assert trace.busy_s == pytest.approx((20 + 8 + 40) * 1e-6)


def test_the_window_is_the_device_span(trace):
    # the first device operation's start (10 us) to the last's end (100)
    assert trace.window_s == pytest.approx(90e-6)
    assert span_s([]) == 0.0


def test_time_by_kernel(trace):
    by = trace.by_name()
    assert by["render_planes_kernel(x)"] == (2, pytest.approx(60e-6))
    assert trace.matching(("env_accumulate",)) == {
        "env_accumulate_kernel(y)": (1, pytest.approx(8e-6))}


def test_gaps_are_named_by_the_host(trace):
    assert trace.gaps() == [("cudaDeviceSynchronize", pytest.approx(20e-6)),
                            ("bench.call", pytest.approx(2e-6))]


class Ctx:
    def __init__(self, trace):
        self.trace, self.steps_per_call = trace, 1
        self.held = (0.9, 0.2)
        self.window = Window(calls=10, seconds=0.01, call_ms=[1.0] * 10)
        self.work = {"n_px": 1000, "live_per_launch": 3000, "n_quads": 4,
                     "n_spheres": 7, "n_materials": 11, "n_texels": 64,
                     "texels_per_launch": 10, "spp": 1}


def test_roofline_reader(trace):
    ctx = Ctx(trace)
    nbytes, flops = load_module("work", "kernel_a").work(ctx.work)
    want = 100 * bound_ms(nbytes, flops) / 0.030      # 30 us a launch
    got = load_module("metrics", "kernel_a_roofline.frame").read(ctx)
    assert got == pytest.approx(want)
    # a kernel the trace does not hold reads nothing
    assert load_module("metrics", "kernel_e_roofline.frame").read(ctx) is None


def test_idle_enqueue_and_small_ops_readers(trace):
    ctx = Ctx(trace)
    assert load_module("metrics", "idle_share.frame").read(ctx) == \
        pytest.approx(100 * (1 - 68 / 90))    # busy 68 us of 90
    assert load_module("metrics", "enqueue_ms.frame").read(ctx) == 0.2
    # the memset is the only operation that is not A-D: 2 us over 2 steps
    assert load_module("metrics", "small_ops_ms.train").read(ctx) == \
        pytest.approx(0.001)
    assert load_module("metrics", "frame_ms_p95").read(ctx) == 1.0


def test_percentile():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile(list(range(101)), 95) == 95
    assert percentile([2.0], 95) == 2.0
