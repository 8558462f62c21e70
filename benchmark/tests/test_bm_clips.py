"""The clip-serving kind (``kinds/serve_clips.py``) on the CPU at a tiny
size (``tiny_clips.py``): a served batch checked clip by clip, the
controls and planted faults failing the check, the face tracks, the
clip counts against hand counts and the temporal metrics' readers on a
synthetic slice."""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import counts_clips
from benchmark.calibrate_clips import worst
from benchmark.harness import CellFiles, load_module, run_cell
from benchmark.kinds import serve_clips
from benchmark.tests.tiny_clips import CELL, CLIP_LIMITS, make_clip_root
from benchmark.trace import Slice

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 12289


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_clip_root(tmp_path_factory.mktemp("bench"))


def run(root, factory=None, limits=None):
    files = CellFiles(root, CELL)
    if limits is not None:
        files.limits = limits
    cells = []

    def make(*a, **kw):
        cells.append((factory or files.kind.Cell)(*a, **kw))
        return cells[-1]

    return run_cell(files, SEED, 0.1, False, torch.device("cpu"), time.perf_counter(),
                    make_cell=make), cells[0]


def test_served_batch_is_checked_per_clip(root):
    r, cell = run(root)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(CLIP_LIMITS)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"faces_per_s", "batch_ms_p95", "setup_s"}
    assert len(cell.kept) == 2  # the checked batches are distinct
    for d in cell.details:
        assert len(d["faces"]["face_rmse"]) == cell.B
        assert len(d["clips"]["features_rel"]) == cell.B // cell.T


def test_fp8_control_fails_the_cards_limits(root):
    limits = json.loads((BENCH / "limits" / "tsf-serve-c16x8.json").read_text())
    r, _ = run(root, serve_clips.controls(CellFiles(root, CELL))["fp8_reference"], limits)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(serve_clips.FAULTS))
def test_clip_faults_exceed_the_limits(root, fault):
    r, _ = run(root, serve_clips.FAULTS[fault])
    assert not r["correct"], r["checks"]
    # The faults lie in the classifier: the per-face stages stay within theirs.
    over = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert over and over <= {"features_rel", "features_rel_max", "logodds_gap",
                             "logodds_gap_max", "e2e_logodds_gap"}, r["checks"]


def test_a_wrong_frame_slot_fails(root):
    """Each frame slot must carry its clip's answer."""

    class SlotCell(serve_clips.Cell):
        def _serve(self, part):
            host = super()._serve(part)
            host["features"] = host["features"].flip(0)
            return host

    r, _ = run(root, SlotCell)
    assert r["checks"]["features_rel_max"]["value"] > r["checks"]["features_rel_max"]["limit"]
    assert r["checks"]["features_rel"]["value"] <= r["checks"]["features_rel"]["limit"]


def test_trace_context_counts_per_clip(root):
    _, cell = run(root)
    ctx = cell.trace_context()
    clip, temporal = counts_clips.model_counts(cell.config["model"], 64)
    assert ctx["clips"] == 2 and ctx["temporal_flops_per_step"] == 2 * temporal
    assert ctx["flops_per_step"] > 2 * clip


def test_track_frames():
    a = serve_clips.track_frames(3, 4, (96, 96), 2**33 + 1, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (12, 96, 96, 3)
    assert torch.equal(a, serve_clips.track_frames(3, 4, (96, 96), 2**33 + 1, "cpu"))
    assert not torch.equal(a, serve_clips.track_frames(3, 4, (96, 96), 2**33 + 2, "cpu"))
    quiet = serve_clips.track_frames(2, 4, (96, 96), 5, "cpu", drift=0.0, scale_step=0.0,
                                     brightness_ramp=0.0, noise_std=0.0)
    # Without motion, ramp and noise a clip is one still frame; clips differ.
    assert all(torch.equal(quiet[i], quiet[0]) for i in range(4))
    assert not torch.equal(quiet[0], quiet[4])
    moving = serve_clips.track_frames(2, 4, (96, 96), 5, "cpu", noise_std=0.0)
    assert not torch.equal(moving[0], moving[3])


def by_hand(P, W, M, depth, heads, image, T, classes=2):
    """2 × multiply-adds of a clip: the patch convolution, per block the
    temporal half (QKV, QKᵀ and ·V over T tokens for each of N patches,
    output projection, Dense_td), the spatial half (the same over 1 + N
    tokens for each of T frames, no Dense_td), the MLP on 1 + N·T tokens,
    and the head."""
    N = (image // P) ** 2
    L = N + 1
    temporal = 2 * N * T * W * (3 * W + W + W) + 2 * 2 * N * T * T * W
    spatial = 2 * T * L * W * (3 * W + W) + 2 * 2 * T * L * L * W
    mlp = 2 * 2 * (1 + N * T) * W * M
    embed = 2 * T * N * W * 3 * P * P
    return embed + depth * (temporal + spatial + mlp) + 2 * W * classes, depth * temporal


@pytest.mark.parametrize("variant,image,frames", [("tiny8", 32, 4), ("base16", 224, 8)])
def test_clip_counts_by_hand(variant, image, frames):
    c = serve_clips.timesformer.VARIANTS[variant]
    clip, temporal = by_hand(c["patch"], c["width"], c["mlp"], c["depth"], c["heads"], image,
                             frames)
    assert counts_clips.clip_flops(variant, image, frames, 2) == clip
    assert counts_clips.temporal_flops(variant, image, frames) == temporal


def test_timesformer_base_is_about_390_gflop_a_clip():
    clip = counts_clips.clip_flops("base16", 224, 8, 2)
    assert 385e9 < clip < 395e9
    assert 0.28 < counts_clips.temporal_flops("base16", 224, 8) / clip < 0.29


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def slice_with(temporal=True):
    """A 1000 µs slice of 2 batches; each batch's temporal spans launch a
    kernel of 100 µs and 50 µs, its spatial span one of 200 µs."""
    events = [ev("user_annotation", "bench.slice", 0, 1000)]
    for b, t in enumerate((0, 500)):
        name = "classify.temporal" if temporal else "classify.other"
        events += [ev("user_annotation", name, t + 10, 40),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 20, 3, corr=10 * b + 1),
                   ev("kernel", "gemm", t + 30, 100, tid=7, corr=10 * b + 1),
                   ev("user_annotation", name, t + 60, 40),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 70, 3, corr=10 * b + 2),
                   ev("kernel", "softmax", t + 140, 50, tid=7, corr=10 * b + 2),
                   ev("user_annotation", "classify.spatial", t + 110, 40),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 120, 3, corr=10 * b + 3),
                   ev("kernel", "gemm", t + 200, 200, tid=7, corr=10 * b + 3)]
    return Slice(events, steps=2)


def reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"test_{name.replace('.', '_')}")


def test_temporal_readers_on_a_synthetic_slice():
    sl = slice_with()
    assert reader("temporal_ms.serve").read(sl, {}) == pytest.approx(0.150)
    # 1.4835e10 operations in 0.150 ms: 98.9 TFLOP/s, 10 % of 989.
    ctx = {"temporal_flops_per_step": 1.4835e10}
    assert reader("temporal_mfu.serve").read(sl, ctx) == pytest.approx(10.0)


def test_temporal_readers_return_none_without_the_span():
    sl = slice_with(temporal=False)
    ctx = {"temporal_flops_per_step": 1e10}
    assert reader("temporal_ms.serve").read(sl, ctx) is None
    assert reader("temporal_mfu.serve").read(sl, ctx) is None
    assert reader("temporal_mfu.serve").read(slice_with(), {}) is None


def test_worst_rows_of_each_group():
    d = {"faces": {"a": torch.tensor([1.0, 3.0, 2.0]), "b": torch.tensor([0.0, 0.0, 5.0])},
         "clips": {"c": torch.tensor([0.5, 0.25])}}
    w = worst(d, n=2)
    assert [r["row"] for r in w["faces.a"]] == [1, 2] and w["faces.b"][0] == {"a": 2.0, "b": 5.0,
                                                                              "row": 2}
    assert [r["row"] for r in w["clips.c"]] == [0, 1]
