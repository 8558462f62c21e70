"""A benchmark root with a tiny Swin cell beside ``tiny.py``'s: a
``tiny2w4`` Swin at 64² faces behind the tiny pipeline, batches of 4 drawn
128² frames as ``tiny.py``'s serving cells have them."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.tests.tiny import PIPELINE, SERVE, SERVE_LIMITS, make_root

SWIN = {"model": {"type": "swin",
                  "feature_extractor": {"variant": "tiny2w4", "image_size": 64,
                                        "dropout_rate": 0.0},
                  "classifier": {"num_classes": 2}},
        "pipeline": PIPELINE}
# Float32 against float32: the serving cells' tiny limits, and end to end
# (the reference's own detection and alignment against the program's).
SWIN_LIMITS = {**SERVE_LIMITS, "e2e_logodds_gap": 1e-2}
CELL = "tiny-swin-serve"


def make_swin_root(tmp: Path, per_layer=()) -> Path:
    """``tiny.make_root`` with the Swin cell added as files and entries."""
    root = make_root(tmp)
    b = root / "benchmark"
    (b / "configs" / "tiny-swin.json").write_text(json.dumps(SWIN))
    (b / "traffic" / "tiny-swin.json").write_text(json.dumps({**SERVE, "kind": "serve_swin"}))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(SWIN_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-swin", "source": "test", "reduced": [], "why": "test",
                             "file": "benchmark/configs/tiny-swin.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny-swin", "traffic": "tiny-swin",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    bench["per_layer"] = list(per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
