"""The trace reader and the per-layer metric readers on a small synthetic
trace: the slice, kernels, a copy, launches inside stage ranges."""

from pathlib import Path

import pytest

from benchmark.harness import load_module
from benchmark.trace import Slice, union_length

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def sl():
    # A 1000 µs slice of 2 steps. Host: the detect range launches kernel 1
    # and 2, the classify range kernel 3; a memcpy of 50 µs. Device busy:
    # [100, 150] copy, [200, 300] and [250, 350] overlap, [600, 800].
    events = [
        ev("user_annotation", "bench.slice", 0, 1000),
        ev("user_annotation", "bench.detect", 10, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        ev("cuda_driver", "cuLaunchKernel", 40, 5, corr=2),
        ev("user_annotation", "bench.classify", 120, 300),
        ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 500, 5, corr=4),  # outside both ranges
        ev("cpu_op", "aten::to", 450, 400),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 100, 50, tid=7),
        ev("kernel", "conv_kernel", 200, 100, tid=7, corr=1),
        ev("kernel", "crop_pool_band_kernel<1>", 250, 100, tid=7, corr=2),
        ev("kernel", "warp_tile_kernel<0>", 600, 200, tid=7, corr=3),
        ev("kernel", "elementwise", 2000, 100, tid=7, corr=4),  # after the slice
    ]
    return Slice(events, steps=2)


def read(name, sl, ctx=None):
    return load_module(METRICS / f"{name}.py", f"m_{name.replace('.', '_')}").read(sl, ctx or {})


def test_union():
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.6)]) == 4


def test_busy_and_idle(sl):
    assert sl.window_s == pytest.approx(1e-3)
    assert sl.busy_s() == pytest.approx(400e-6)  # 50 + 150 + 200, the late kernel clipped out
    assert read("idle_share.serve", sl) == pytest.approx(60.0)


def test_ranges(sl):
    assert sl.range_ms("bench.detect") == pytest.approx(0.2)
    assert read("detect_ms.serve", sl) == pytest.approx(0.1)
    assert read("classify_ms.serve", sl) == pytest.approx(0.1)
    assert sl.range_ms("bench.nothing") is None


def test_h2d(sl):
    assert read("h2d_ms.serve", sl) == pytest.approx(0.025)


def test_warp_roofline(sl):
    # 300 µs of crop and warp kernels over 2 steps; 167.5 MB a step at 3.35 TB/s is 50 µs.
    got = read("warp_roofline.serve", sl, {"warp_bytes_per_step": 167.5e6})
    assert got == pytest.approx(100 * 50 / 150)
    assert read("warp_roofline.serve", sl, {}) is None


def test_mfu():
    ctx = {"flops_per_step": 989e12 * 0.01, "window_steps": 50, "window_s": 10.0}
    assert read("mfu.serve", None, ctx) == pytest.approx(5.0)


def test_empty_range_reads_nothing():
    s = Slice([ev("user_annotation", "bench.slice", 0, 10)], steps=1)
    assert read("detect_ms.serve", s) is None
    assert read("idle_share.serve", s) is None


def test_breakdown(sl):
    ops = sl.top_ops()
    assert ops[0] == ["warp_tile_kernel<0>", pytest.approx(200e-6)]
    gaps = sl.idle_gaps()
    assert gaps[0][0] == "aten::to" and gaps[0][1] == pytest.approx(250e-6)
