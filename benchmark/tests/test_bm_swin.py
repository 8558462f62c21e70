"""The Swin serving kind (``kinds/serve_swin.py``) on the CPU at a tiny size
(``tiny_swin.py``): a served batch checked face by face, the controls and
planted faults failing the check, the counts against hand counts, the
window metrics' readers on a synthetic slice, and the reference importing
nothing of the program."""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import counts_swin
from benchmark.harness import CellFiles, load_module, run_cell
from benchmark.kinds import serve_swin
from benchmark.tests.test_bm_clips import ev
from benchmark.tests.test_bm_imports import BANNED, top_level_imports
from benchmark.tests.tiny_swin import CELL, SWIN_LIMITS, make_swin_root
from benchmark.trace import Slice

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 12289


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_swin_root(tmp_path_factory.mktemp("bench"))


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


def test_served_batch_is_checked_per_face(root):
    r, cell = run(root)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(SWIN_LIMITS)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"faces_per_s", "batch_ms_p95", "setup_s"}
    assert len(cell.kept) == 2
    for d in cell.details:
        assert len(d["faces"]["features_rel"]) == cell.B


def test_the_cards_limits_carry_their_readings():
    limits = json.loads((BENCH / "limits" / "swin-serve-b128.json").read_text())
    assert set(limits) == set(SWIN_LIMITS)
    for name, entry in limits.items():
        assert {"limit", "lower", "upper", "upper_by", "why"} <= set(entry), name
        assert entry["lower"] < entry["limit"] < entry["upper"], name


def test_fp8_control_fails_the_cards_limits(root):
    limits = json.loads((BENCH / "limits" / "swin-serve-b128.json").read_text())
    r, _ = run(root, serve_swin.controls(CellFiles(root, CELL))["fp8_reference"], limits)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(serve_swin.FAULTS))
def test_swin_faults_exceed_the_limits(root, fault):
    r, _ = run(root, serve_swin.FAULTS[fault])
    assert not r["correct"], r["checks"]
    # The faults lie in the classifier's features: the other stages, and the
    # head judged on the served features, stay within theirs.
    over = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert over and over <= {"features_rel", "features_rel_max", "e2e_logodds_gap"}, r["checks"]


def test_trace_context_counts_the_window_halves(root):
    _, cell = run(root)
    ctx = cell.trace_context()
    face, window = counts_swin.model_counts(cell.config["model"], 64)
    assert ctx["batch"] == cell.B and ctx["window_flops_per_step"] == cell.B * window
    assert ctx["flops_per_step"] > cell.B * face


def by_hand(variant, image, classes=2):
    """2 × multiply-adds of a face: the patch convolution, per block the
    window half (QKV and the output projection on every token, QKᵀ and ·V
    over each window's w² tokens) and the MLP (ratio 4), each merge's
    4C → 2C product, and the head."""
    c = serve_swin.swin.VARIANTS[variant]
    n = (image // c["patch"]) ** 2
    total = 2 * n * c["embed"] * 3 * c["patch"] ** 2
    window = 0
    for s, st in enumerate(serve_swin.swin.stages(variant, image)):
        tokens, C, L = st["res"] ** 2, st["width"], st["window"] ** 2
        half = 2 * tokens * 4 * C * C + 2 * 2 * tokens * L * C
        window += st["depth"] * half
        total += st["depth"] * (half + 2 * 2 * tokens * C * 4 * C)
        if s < 3:
            total += 2 * (tokens // 4) * 4 * C * 2 * C
    return total + 2 * st["width"] * classes, window


@pytest.mark.parametrize("variant,image", [("tiny2w4", 64), ("base4w7", 224)])
def test_counts_by_hand(variant, image):
    face, window = by_hand(variant, image)
    assert counts_swin.face_flops(variant, image, 2) == face
    assert counts_swin.window_flops(variant, image) == window


def test_swin_b_is_about_31_gflop_a_face():
    """The hand count: 15.43 GMAC a face, 5,237,370,880 MAC of them in the
    window halves (1.341 TFLOP a batch of 128, 34 % of the whole)."""
    face = counts_swin.face_flops("base4w7", 224, 2)
    window = counts_swin.window_flops("base4w7", 224)
    assert abs(face / 30.86e9 - 1) < 0.01
    assert window == 2 * 5_237_370_880
    assert abs(128 * window / 1.341e12 - 1) < 0.01 and 0.33 < window / face < 0.35


def slice_with(window=True):
    """A 1000 µs slice of 2 batches; each batch's window spans launch a
    kernel of 120 µs and 30 µs, its merge span one of 200 µs."""
    events = [ev("user_annotation", "bench.slice", 0, 1000)]
    for b, t in enumerate((0, 500)):
        name = "classify.window" if window else "classify.other"
        events += [ev("user_annotation", name, t + 10, 40),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 20, 3, corr=10 * b + 1),
                   ev("kernel", "gemm", t + 30, 120, tid=7, corr=10 * b + 1),
                   ev("user_annotation", name, t + 60, 40),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 70, 3, corr=10 * b + 2),
                   ev("kernel", "softmax", t + 160, 30, tid=7, corr=10 * b + 2),
                   ev("user_annotation", "classify.merge", t + 110, 40),
                   ev("cuda_runtime", "cudaLaunchKernel", t + 120, 3, corr=10 * b + 3),
                   ev("kernel", "gemm", t + 200, 200, tid=7, corr=10 * b + 3)]
    return Slice(events, steps=2)


def reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"test_{name.replace('.', '_')}")


def test_window_readers_on_a_synthetic_slice():
    sl = slice_with()
    assert reader("window_ms.serve").read(sl, {}) == pytest.approx(0.150)
    # 1.4835e10 operations in 0.150 ms: 98.9 TFLOP/s, 10 % of 989.
    assert reader("window_mfu.serve").read(sl, {"window_flops_per_step": 1.4835e10}) == \
        pytest.approx(10.0)


def test_window_readers_return_none_without_the_span():
    ctx = {"window_flops_per_step": 1e10}
    assert reader("window_ms.serve").read(slice_with(window=False), ctx) is None
    assert reader("window_mfu.serve").read(slice_with(window=False), ctx) is None
    assert reader("window_mfu.serve").read(slice_with(), {}) is None


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference" / "swin.py", BENCH / "counts_swin.py"):
        assert not top_level_imports(path) & (BANNED | {"deepfake_vit_tpu_torch"}), path
