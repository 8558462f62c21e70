"""The port's serving spans on the CPU: ``e2e.FusedPipeline.forward`` under
``torch.profiler`` emits one ``serve.forward`` range a call, holding the six
stage ranges once each, in order and apart, with every operation of the
call inside one of them, and ``classify.attention`` inside
``serve.classify`` (once for an EfficientNet, once a block for a ViT).
The outputs do not depend on the profiler, and without one ``annotate``
enters no ``record_function``. ``device_work`` keeps a profile's kernel
rows and leaves out the device rows that ranges such as these span.

A b0 pipeline at ``tests/test_torch_e2e.py``'s sizes and a ``tiny16`` ViT
at the same sizes, float32, seeded weights."""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent, FunctionEventAvg
from torch.profiler import ProfilerActivity, profile

from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.utils import profiling

torch.set_num_threads(1)

COMMON = dict(detection_input_size=(128, 128), serving_size=(256, 256), output_size=(64, 64),
              warp_window=64, warp_fractional=True, confidence_threshold=0.0)
MODELS = {
    "b0": {"feature_extractor": {"variant": "b0", "dropout_rate": 0.0},
           "classifier": {"hidden_dims": [16], "num_classes": 2}},
    "tiny16": {"type": "vit", "feature_extractor": {"variant": "tiny16", "image_size": 64},
               "classifier": {"num_classes": 2}},
}
ATTENTION_SPANS = {"b0": 1, "tiny16": 12}
STAGES = ["serve.frames_in", "serve.canvas", "serve.detect", "serve.align", "serve.quality",
          "serve.classify"]
CALLS = 2


@pytest.fixture(scope="module", params=sorted(MODELS))
def served(request, tmp_path_factory):
    """The pipeline, its frames, its outputs without a profiler, and the
    trace events of ``CALLS`` profiled calls with their outputs."""
    pipe = FusedPipeline({"model": MODELS[request.param]}, dtype=torch.float32, device="cpu",
                         **COMMON)
    pipe.init_variables(seed=0)
    frames = np.random.default_rng(5).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    plain = pipe.forward(frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = [pipe.forward(frames) for _ in range(CALLS)]
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    return request.param, pipe, frames, plain, traced, events


def spans(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name)


def inside(a, b, span):
    return span[0] <= a and b <= span[1]


def test_one_forward_span_a_call(served):
    events = served[-1]
    assert len(spans(events, "serve.forward")) == CALLS


def test_stage_spans_once_in_order_and_apart(served):
    events = served[-1]
    for fwd in spans(events, "serve.forward"):
        stages = sorted((a, b, name) for name in STAGES for a, b in spans(events, name)
                        if inside(a, b, fwd))
        assert [name for _, _, name in stages] == STAGES
        for (_, end, _), (start, _, _) in zip(stages, stages[1:]):
            assert end <= start


def test_every_operation_in_one_stage(served):
    """The CPU's view of "every kernel ``forward`` launches falls in one stage
    span": every operator the call runs lies inside exactly one of them."""
    events = served[-1]
    stage_spans = [s for name in STAGES for s in spans(events, name)]
    for fwd in spans(events, "serve.forward"):
        ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "cpu_op" and inside(e["ts"], e["ts"] + e["dur"], fwd)]
        assert ops
        for a, b in ops:
            assert sum(inside(a, b, s) for s in stage_spans) == 1


def test_attention_spans_inside_classify(served):
    model, _, _, _, _, events = served
    classify = spans(events, "serve.classify")
    attention = spans(events, "classify.attention")
    assert len(attention) == CALLS * ATTENTION_SPANS[model]
    for cl in classify:
        assert sum(inside(a, b, cl) for a, b in attention) == ATTENTION_SPANS[model]


def test_outputs_do_not_depend_on_the_profiler(served):
    _, _, _, plain, traced, _ = served
    for out in traced:
        assert out.keys() == plain.keys()
        for k in plain:
            assert torch.equal(out[k], plain[k]), k


def test_no_range_without_a_profiler(served, monkeypatch):
    _, pipe, frames, plain, _, _ = served

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    out = pipe.forward(frames)
    for k in plain:
        assert torch.equal(out[k], plain[k]), k
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError):
        with profiling.annotate("serve.forward"):
            pass


def _event(i, name, device_type, annotation=False):
    return FunctionEvent(id=i, name=name, thread=0, start_us=10 * i, end_us=10 * i + 5,
                         device_type=device_type, is_user_annotation=annotation)


@pytest.mark.parametrize("averaged", [False, True])
def test_device_work_leaves_out_ranges(averaged):
    """A kernel and a copy are device work; a range's device row is not,
    whether flagged as a user annotation or only named as a host range."""
    events = [
        _event(0, "serve.classify", DeviceType.CPU, annotation=True),
        _event(1, "serve.classify", DeviceType.CUDA, annotation=True),
        _event(2, "Optimizer.step#AdamW.step", DeviceType.CPU, annotation=True),
        _event(3, "Optimizer.step#AdamW.step", DeviceType.CUDA),
        _event(4, "aten::mm", DeviceType.CPU),
        _event(5, "sm90_xmma_gemm_bf16", DeviceType.CUDA),
        _event(6, "sm90_xmma_gemm_bf16", DeviceType.CUDA),
        _event(7, "Memcpy HtoD (Pinned -> Device)", DeviceType.CUDA),
    ]
    rows = events
    if averaged:  # as key_averages() groups them: one row a name and device
        groups = {}
        for ev in events:
            groups.setdefault((ev.key, ev.device_type), FunctionEventAvg()).add(ev)
        rows = list(groups.values())
    got = sorted(ev.key for ev in profiling.device_work(rows))
    want = ["Memcpy HtoD (Pinned -> Device)", "sm90_xmma_gemm_bf16"]
    assert got == (want if averaged else [want[0], want[1], want[1]])


def test_annotate_rows_are_user_annotations():
    """The host row of an ``annotate`` range carries the user-annotation
    flag that ``device_work`` reads; an operator's row does not."""
    x = torch.ones(4, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("serve.quality"):
            x = x @ x
    rows = {ev.key: ev for ev in prof.key_averages()}
    assert rows["serve.quality"].is_user_annotation
    assert not rows["aten::mm"].is_user_annotation
    assert profiling.device_work(prof.key_averages()) == []
