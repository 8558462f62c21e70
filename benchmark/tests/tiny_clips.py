"""A benchmark root with a tiny clip cell beside ``tiny.py``'s: a
``tiny8`` TimeSformer of 4 frames at 64² faces behind the tiny pipeline,
batches of 2 clips of drawn face tracks on 128² frames."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.tests.tiny import PIPELINE, SERVE_LIMITS, make_root

TSF = {"model": {"type": "timesformer",
                 "feature_extractor": {"variant": "tiny8", "image_size": 64, "num_frames": 4,
                                       "dropout_rate": 0.0},
                 "classifier": {"num_classes": 2}},
       "pipeline": PIPELINE}
CLIPS = {"kind": "serve_clips", "batch": 8, "clip_frames": 4, "frame_size": [128, 128],
         "face_half_width": [0.08, 0.22], "drift": 0.02, "scale_step": 0.03,
         "brightness_ramp": 16.0, "noise_std": 4.0, "pool_batches": 2, "warmup_batches": 1,
         "trace_steps": 2, "check_batches": 2}
# Float32 against float32: the serving cells' tiny limits, and the clips'
# end to end (the reference's own detection and alignment against the
# program's).
CLIP_LIMITS = {**SERVE_LIMITS, "e2e_logodds_gap": 1e-2}
CELL = "tiny-tsf-clips"


def make_clip_root(tmp: Path, per_layer=()) -> Path:
    """``tiny.make_root`` with the clip cell added as files and entries."""
    root = make_root(tmp)
    b = root / "benchmark"
    (b / "configs" / "tiny-tsf.json").write_text(json.dumps(TSF))
    (b / "traffic" / "tiny-clips.json").write_text(json.dumps(CLIPS))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(CLIP_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-tsf", "source": "test", "reduced": [], "why": "test",
                             "file": "benchmark/configs/tiny-tsf.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny-tsf", "traffic": "tiny-clips",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    bench["per_layer"] = list(per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
