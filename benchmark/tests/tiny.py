"""A benchmark root at a size the CPU runs in seconds: a copy of
``benchmark/`` with small configurations, traffic and limits beside the
real ones, and a ``BENCHMARK.json`` naming only those cells."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DETECTOR = REPO / "deepfake_vit_tpu" / "weights" / "scrfd_synface.msgpack"

PIPELINE = {"serving_size": [128, 128], "detection_input_size": [64, 64], "output_size": [64, 64],
            "warp_window": 64, "warp_fractional": False, "warp_tap_mode": "legacy",
            "dtype": "float32", "confidence_threshold": 0.5, "keep_top_k": 1,
            "detector_arch": "scrfd", "detector_weights": str(DETECTOR)}
B0 = {"model": {"feature_extractor": {"variant": "b0", "dropout_rate": 0.4, "use_attention": True,
                                      "attention_config": {"use_landmark": True, "use_spatial": True,
                                                           "use_channel": True}},
                "classifier": {"hidden_dims": [32, 16], "dropout_rate": 0.4, "num_classes": 2}},
      "pipeline": PIPELINE,
      # The program's own lower-precision path (int8 detector and tail).
      "lower_precision": {"use_int8_detector": True, "use_int8_tail": True}}
VIT = {"model": {"type": "vit", "feature_extractor": {"variant": "tiny16", "image_size": 64,
                                                      "dropout_rate": 0.0},
                 "classifier": {"num_classes": 2}},
       "pipeline": PIPELINE}
SERVE = {"kind": "serve_closed", "batch": 4, "frame_size": [128, 128], "faces_per_frame": 1,
         "face_half_width": [0.08, 0.22], "noise_std": 4.0, "pool_batches": 2,
         "warmup_batches": 1, "trace_steps": 2, "check_batches": 2}
# Float32 program against the float32 reference on the CPU: agreement to
# rounding, far below the card's bf16 limits. The warp rounds its taps and
# pooled pixels to bf16 in every pipeline dtype (half a grey level RMSE).
SERVE_LIMITS = {"det_logit_gap": 1e-3, "det_box_px": 1e-2, "det_landmarks_px": 1e-2,
                "align_landmarks_px": 1e-2, "face_rmse": 1.0, "quality_gap": 1e-3,
                "logodds_gap": 1e-2, "logodds_gap_max": 1e-2, "features_rel": 1e-3,
                "features_rel_max": 1e-3}
CELLS = {"tiny-b0-serve": ("tiny-b0", "tiny-serve", SERVE_LIMITS),
         "tiny-vit-serve": ("tiny-vit", "tiny-serve", SERVE_LIMITS)}


def make_root(tmp: Path, per_layer=()) -> Path:
    """A benchmark root under ``tmp`` with the tiny cells."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / "benchmark"
    (b / "configs" / "tiny-b0.json").write_text(json.dumps(B0))
    (b / "configs" / "tiny-vit.json").write_text(json.dumps(VIT))
    (b / "traffic" / "tiny-serve.json").write_text(json.dumps(SERVE))
    for cell, (_, _, limits) in CELLS.items():
        (b / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    serve = list(CELLS)
    bench = {
        "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"], "run_seconds": 1,
        "configs": [{"name": n, "source": "test", "file": f"benchmark/configs/{n}.json",
                     "reduced": [], "why": "test"} for n in ("tiny-b0", "tiny-vit")],
        "workloads": [{"name": c, "config": cfg, "traffic": tr, "chips": 1, "why": "test"}
                      for c, (cfg, tr, _) in CELLS.items()],
        "end_to_end": [
            {"name": "faces_per_s", "unit": "faces/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": serve},
            {"name": "batch_ms_p95", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock", "workloads": serve},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": list(per_layer),
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
