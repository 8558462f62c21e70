"""``BENCHMARK.json`` keeps to its contract, every name it holds finds its
file, and a configuration, a traffic mix and a per-layer metric added as
new files and entries run with no edit to any file already there."""

import json
import re
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import CellFiles, run_cell
from benchmark.tests.tiny import B0, SERVE, SERVE_LIMITS, make_root

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_budget_fits_the_check():
    cells = 24  # later PRs may fill the benchmark up to its limit
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["name"] in used and c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] == 1
        files = CellFiles(REPO, w["name"])
        assert files.limits and files.kind.Cell


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and one_line(m["layer"]) and m["moves"] in e2e
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        files = CellFiles(REPO, w["name"])
        reported = {m["name"] for m in files.metrics("end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert files.metrics("per_layer")
        for m in BENCH["per_layer"]:
            if "mfu" in m["name"] or m["name"].endswith("_roofline.serve"):
                assert m["unit"] == "%"


def test_added_as_files(tmp_path):
    """A new configuration, mix and metric, each its own file and entry."""
    root = make_root(tmp_path, per_layer=[
        {"name": "faces_seen.serve", "unit": "faces", "better": "higher", "source": "host_clock",
         "layer": "test", "moves": "faces_per_s", "workloads": ["new-cell"]}])
    b = root / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    (b / "configs" / "new-config.json").write_text(json.dumps(B0))
    (b / "traffic" / "new-mix.json").write_text(json.dumps(dict(SERVE, batch=2)))
    (b / "limits" / "new-cell.json").write_text(json.dumps(SERVE_LIMITS))
    (b / "metrics" / "faces_seen.serve.py").write_text(
        "def read(sl, ctx):\n    return ctx['window_steps'] * ctx['batch']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "test", "reduced": [], "why": "test",
                             "file": "benchmark/configs/new-config.json"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config", "traffic": "new-mix",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny-b0-serve" in m["workloads"]:
            m["workloads"].append("new-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    r = run_cell(CellFiles(root, "new-cell"), 77, 0.2, True, torch.device("cpu"),
                 time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["metrics"]["faces_seen.serve"]["value"] >= 2
    assert r["device"]["window_s"] > 0
    assert all(p.read_bytes() == data for p, data in before.items())


def _add_cell(root, name, config):
    """A cell of its own configuration file, the tiny traffic and limits."""
    b = root / "benchmark"
    (b / "configs" / f"{name}.json").write_text(json.dumps(config))
    (b / "limits" / f"{name}.json").write_text(json.dumps(SERVE_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                             "file": f"benchmark/configs/{name}.json"})
    bench["workloads"].append({"name": name, "config": name, "traffic": "tiny-serve",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return CellFiles(root, name)


def _with(**options):
    return dict(B0, pipeline=dict(B0["pipeline"], **options))


def test_program_options_added_as_files(tmp_path):
    """A configuration that sets program options runs with them: options
    that keep the function read correct, the int8 tail reads not correct
    under float32 limits (it is not dropped on the way)."""
    root = make_root(tmp_path)
    b = root / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    same = _add_cell(root, "options-same", _with(confidence_threshold=0.3, nms_threshold=0.3))
    r = run_cell(same, 78, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    int8 = _add_cell(root, "options-int8", _with(use_int8_tail=True))
    r = run_cell(int8, 78, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert not r["correct"], r["checks"]
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("options", [{"keep_top_k": 3}, {"detector_arch": "lite"},
                                     {"compute_quality": False},
                                     {"warp_tap_mode": "uw16"}, {"warp_fractional": True},
                                     {"reference_landmarks": {"left_eye": [0.3, 0.4]}},
                                     {"no_such_option": 1}])
def test_options_the_reference_cannot_judge_are_refused(tmp_path, options):
    root = make_root(tmp_path)
    files = _add_cell(root, "refused", _with(**options))
    with pytest.raises(ValueError):
        run_cell(files, 79, 0.1, False, torch.device("cpu"), time.perf_counter())
