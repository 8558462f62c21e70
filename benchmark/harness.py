"""The benchmark's run of one cell, driven by the files ``BENCHMARK.json``
names.

A cell's configuration is ``benchmark/configs/<config>.json``, its traffic
``benchmark/traffic/<traffic>.json`` (whose ``kind`` picks the driver
``benchmark/kinds/<kind>.py``), the limits of its output check
``benchmark/limits/<cell>.json``, and each per-layer metric a reader
``benchmark/metrics/<metric>.py`` with ``read(trace, ctx)``. A cell, a
configuration, a mix or a metric is added as new files and entries.

A run: set-up (the program, its weights, the inputs, the warm-up), then
with ``trace`` a short profiled slice, then the window of ``seconds``
(never profiled), then the peak memory is read, the program's state freed
and the output check run against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from .trace import profile_slice

BANNED = ("jax", "jaxlib", "flax", "deepfake_vit_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class CellFiles:
    """The files of one cell, found by the names in ``BENCHMARK.json``."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads((self.root / configs[self.cell["config"]]["file"]).read_text())
        here = self.root / "benchmark"
        self.traffic = json.loads((here / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.limits = json.loads((here / "limits" / f"{workload}.json").read_text())
        self.kind = load_module(here / "kinds" / f"{self.traffic['kind']}.py",
                                f"benchmark_kind_{self.traffic['kind']}")

    def metrics(self, section: str):
        """The cell's metrics of ``end_to_end`` or ``per_layer``."""
        name = self.cell["name"]
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if "workloads" not in m or name in m["workloads"]}
        out = []
        for m in self.bench[section]:
            if "workloads" in m:
                if name in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def run_cell(files: CellFiles, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, make_cell: Optional[Callable[..., Any]] = None) -> Dict[str, Any]:
    """One run of a cell; returns the result line's object."""
    factory = make_cell or files.kind.Cell
    cell = factory(files.root, files.config, files.traffic, files.limits, seed, device, trace)
    ctx: Dict[str, Any] = {"cell": files.cell["name"]}
    sl = None
    if trace:
        sl = profile_slice(cell.step, int(files.traffic["trace_steps"]),
                           files.root / "build" / "benchmark" / f"trace-{files.cell['name']}.json",
                           lambda: sync(device))
    setup_s = time.perf_counter() - t_start

    cell.begin_window()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds or steps < cell.min_steps:
        cell.step()
        steps += 1
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    e2e = cell.window_metrics(window_s)
    attempted, failed = cell.attempted_failed()
    ctx.update(window_steps=steps, window_s=window_s)
    if trace:
        ctx.update(cell.trace_context())

    cell.release()
    checks = cell.check()
    if not checks:
        raise RuntimeError("the output check compared nothing")
    if trace:
        ctx.update(cell.after_check_context())

    if trace:
        metrics = {}
        for m in files.metrics("per_layer"):
            reader = load_module(files.root / "benchmark" / "metrics" / f"{m['name']}.py",
                                 f"benchmark_metric_{m['name'].replace('.', '_')}")
            value = reader.read(sl, ctx)
            if value is None:
                raise RuntimeError(f"per-layer metric {m['name']} found nothing to read in "
                                   f"cell {files.cell['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in files.metrics("end_to_end"):
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is None:
                raise RuntimeError(f"end-to-end metric {m['name']} is not measured by the "
                                   f"{files.traffic['kind']} driver")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    if device.type == "cuda":
        dev_info["power_limit"] = power_limit()
    result: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev_info}
    if sl is not None:
        dev_info["busy_s"] = sl.busy_s()
        dev_info["window_s"] = sl.window_s
        result["breakdown"] = {"device_ops": sl.top_ops(), "idle_gaps": sl.idle_gaps()}
    result["checks"] = checks
    return result
