"""A profiled slice of a run, read back from ``torch.profiler``'s trace.

``profile_slice(step, n, path)`` runs ``step`` n times inside a
``bench.slice`` range under the profiler, writes the trace (JSON, a few MB)
to ``path`` and returns a ``Slice``; the file is removed once read. The
slice's window is that range's span on the host clock; device activity is
every kernel, memcpy and memset record. A range's device time is the time
of the kernels whose launch (a CUDA runtime or driver call, matched by its
correlation id) lies inside an instance of the range on the same thread.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Callable, List, Optional, Tuple

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union_length(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class Slice:
    """The events of one profiled slice (times in microseconds)."""

    def __init__(self, events: List[dict], steps: int):
        self.steps = steps
        spans = [e for e in events if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError("the trace holds no record of the profiled slice")
        self.t0 = spans[0]["ts"]
        self.t1 = spans[0]["ts"] + spans[0]["dur"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.events = events

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        iv = [(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)) for e in self.device]
        return union_length([(a, b) for a, b in iv if b > a]) * 1e-6

    def kernel_ms(self, *names: str) -> float:
        """Device ms of the kernels whose name holds any of ``names``."""
        return sum(e["dur"] for e in self.kernels if any(n in e["name"] for n in names)) * 1e-3

    def memcpy_ms(self, kind: str) -> float:
        return sum(e["dur"] for e in self.device
                   if e["cat"] == "gpu_memcpy" and kind in e["name"]) * 1e-3

    def range_ms(self, name: str) -> Optional[float]:
        """Device ms of the kernels launched inside range ``name``, or None
        when no kernel was."""
        ranges = defaultdict(list)
        for e in self.events:
            if e.get("cat") == "user_annotation" and e.get("name") == name:
                ranges[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
        corr = set()
        for e in self.events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                for a, b in ranges.get(e.get("tid"), ()):
                    if a <= e["ts"] <= b:
                        corr.add(e["args"]["correlation"])
                        break
        ks = [e for e in self.kernels if e.get("args", {}).get("correlation") in corr]
        return sum(e["dur"] for e in ks) * 1e-3 if ks else None

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for e in self.device:
            by[e["name"]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches of the slice with no device activity, each
        named by the innermost host operation running at its middle."""
        iv = sorted((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                    for e in self.device)
        iv = [(a, b) for a, b in iv if b > a]
        gaps, end = [], self.t0
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        host = [e for e in self.events if e.get("ph") == "X"
                and e.get("cat") in ("cpu_op", "user_annotation", *LAUNCH_CATS)
                and e.get("name") != SLICE]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            inner = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = max(inner, key=lambda e: e["ts"])["name"] if inner else "host outside any op"
            out.append([name, (b - a) * 1e-6])
        return out


def profile_slice(step: Callable[[], object], n: int, path: Path,
                  sync: Callable[[], None]) -> Slice:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            for _ in range(n):
                step()
            sync()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Slice(events, n)
