"""The readers of the program's spans (``serve.*``, ``classify.attention``)
on a small synthetic trace, against values worked out by hand, and on the
card the launch rule of ``kernels_per_batch.serve`` under a replayed CUDA
graph."""

import json
from pathlib import Path

import pytest

from benchmark.harness import load_module
from benchmark.trace import Slice

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SPAN_METRICS = ["canvas_ms.serve", "align_ms.serve", "quality_ms.serve", "attention_ms.serve",
                "forward_idle_ms.serve", "kernels_per_batch.serve"]
STAGES = ["serve.frames_in", "serve.canvas", "serve.detect", "serve.align", "serve.quality",
          "serve.classify"]


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def batch(t, c, graph=False, skip=()):
    """One ``serve.forward`` of 400 µs from ``t`` on the host, its launches
    numbered from ``c``, and what the device ran for it (times from ``t``):

    frames_in [2, 20]   copy launched at 5            device [10, 50]
    canvas    [20, 50]  kernel launched at 25          device [50, 70]
    detect    [50, 140] kernel launched at 60          device [70, 170]
    align     [140, 190] kernel launched at 150        device [180, 190]
    quality   [190, 220] kernel launched at 200        device [190, 205]
    classify  [220, 390] attention [240, 290] launches one at 250, device
                         [250, 290]; a launch at 310, device [340, 390]
                         (with ``graph``: a graph launch of two kernels,
                         [340, 365] and [365, 390])

    Busy inside the span: [10, 170] + [180, 205] + [250, 290] + [340, 390]
    = 275 of 400 µs, so 125 µs idle."""
    host = [ev("user_annotation", "serve.forward", t, 400)]
    for name, (a, b) in zip(STAGES, [(2, 20), (20, 50), (50, 140), (140, 190), (190, 220),
                                     (220, 390)]):
        if name not in skip:
            host.append(ev("user_annotation", name, t + a, b - a))
    host.append(ev("user_annotation", "classify.attention", t + 240, 50))
    host += [ev("cuda_runtime", "cudaMemcpyAsync", t + 5, 3, corr=c),
             ev("cuda_runtime", "cudaLaunchKernel", t + 25, 3, corr=c + 1),
             ev("cuda_driver", "cuLaunchKernel", t + 60, 3, corr=c + 2),
             ev("cuda_runtime", "cudaLaunchKernel", t + 150, 3, corr=c + 3),
             ev("cuda_runtime", "cudaLaunchKernel", t + 200, 3, corr=c + 4),
             ev("cuda_runtime", "cudaLaunchKernel", t + 250, 3, corr=c + 5),
             ev("cuda_runtime", "cudaGraphLaunch" if graph else "cudaLaunchKernel", t + 310, 3,
                corr=c + 6)]
    dev = [ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t + 10, 40, tid=7, corr=c),
           ev("kernel", "cast", t + 50, 20, tid=7, corr=c + 1),
           ev("kernel", "conv", t + 70, 100, tid=7, corr=c + 2),
           ev("kernel", "warp_tile_kernel<0>", t + 180, 10, tid=7, corr=c + 3),
           ev("kernel", "quality", t + 190, 15, tid=7, corr=c + 4),
           ev("kernel", "softmax", t + 250, 40, tid=7, corr=c + 5)]
    if graph:
        dev += [ev("kernel", "gemm", t + 340, 25, tid=7, corr=c + 6),
                ev("kernel", "gelu", t + 365, 25, tid=7, corr=c + 6)]
    else:
        dev.append(ev("kernel", "gemm", t + 340, 50, tid=7, corr=c + 6))
    return host + dev


def slice_of(**kwargs):
    # A 1000 µs slice of 2 batches: forwards at 10 and 500 (the second's last
    # launch a CUDA graph of two kernels), and between them the caller's own
    # kernel, launched at 450 outside both spans, on the device [450, 470].
    events = [ev("user_annotation", "bench.slice", 0, 1000),
              *batch(10, 1, **kwargs), *batch(500, 11, graph=True, **kwargs),
              ev("cuda_runtime", "cudaLaunchKernel", 450, 3, corr=30),
              ev("kernel", "caller", 450, 20, tid=7, corr=30)]
    return Slice(events, steps=2)


def read(name, sl, ctx=None):
    return load_module(METRICS / f"{name}.py", f"m_{name.replace('.', '_')}").read(sl, ctx or {})


def test_stage_ms():
    sl = slice_of()
    assert read("canvas_ms.serve", sl) == pytest.approx(0.020)
    assert read("align_ms.serve", sl) == pytest.approx(0.010)
    assert read("quality_ms.serve", sl) == pytest.approx(0.015)
    assert read("attention_ms.serve", sl) == pytest.approx(0.040)


def test_stages_add_up_to_forward():
    sl = slice_of()
    stages = sum(sl.range_ms(s) or 0.0 for s in STAGES)
    assert sl.range_ms("serve.forward") == pytest.approx(2 * 0.235)
    assert stages == pytest.approx(sl.range_ms("serve.forward"))
    assert sl.range_ms("serve.frames_in") is None  # a copy, no kernel


def test_forward_idle_inside_the_spans_only():
    sl = slice_of()
    # 125 µs a span; the slice's idle time outside them (before the first,
    # between them around the caller's kernel, after the second) is not counted.
    assert read("forward_idle_ms.serve", sl) == pytest.approx(0.125)
    idle_ms = read("idle_share.serve", sl) / 100 * sl.window_s * 1e3 / sl.steps
    assert idle_ms == pytest.approx(0.215)  # 1000 − 2 × 275 − 20 busy, over 2
    assert read("forward_idle_ms.serve", sl) < idle_ms


def test_kernels_per_batch_by_correlation():
    # 6 kernels in the first batch, 7 in the second (the graph launch's two
    # kernels share its correlation id); the copy and the caller's kernel
    # are not counted.
    assert read("kernels_per_batch.serve", slice_of()) == pytest.approx(6.5)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read_without_the_spans(name):
    s = Slice([ev("user_annotation", "bench.slice", 0, 10),
               ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
               ev("kernel", "k", 3, 4, tid=7, corr=1)], steps=1)
    assert read(name, s) is None


def test_a_missing_stage_reads_nothing():
    sl = slice_of(skip=("serve.align",))
    assert read("align_ms.serve", sl) is None
    assert read("canvas_ms.serve", sl) == pytest.approx(0.020)


@pytest.mark.gpu
def test_graph_kernels_are_counted(tmp_path):
    """A captured CUDA graph replayed inside ``serve.forward`` spans: the
    launch rule counts the graph's kernels, as many as the same operations
    launch eagerly."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(1 << 20, device="cuda")

    def work():
        return ((x * 2.0 + 1.0).sin() * x).sum()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            work()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        work()
    torch.cuda.synchronize()

    def counted(step):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.slice"):
                for _ in range(2):
                    with torch.profiler.record_function("serve.forward"):
                        step()
                torch.cuda.synchronize()
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        sl = Slice(json.loads(path.read_text())["traceEvents"], steps=2)
        return read("kernels_per_batch.serve", sl), sl

    eager, _ = counted(work)
    replayed, sl = counted(graph.replay)
    assert any(e.get("name") == "cudaGraphLaunch" for e in sl.events)
    assert eager and eager >= 3
    assert replayed == eager
