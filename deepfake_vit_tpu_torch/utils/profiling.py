"""Profiling hooks of the port.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``device_sync(tree)``: waits for the card when any tensor of ``tree`` is
  on a CUDA device (``torch.cuda.synchronize``; CPU tensors need no wait);
- ``trace(logdir)``: ``torch.profiler`` over the CPU and, when there is a
  card, CUDA activity, writing a Chrome trace (``trace.json`` under
  ``logdir``, readable by Perfetto and ``chrome://tracing``); the profile
  is yielded, so its ``key_averages()`` can be read after the block;
- ``annotate(name)``: a named range in the trace (``record_function``);
- ``StepTimer``: per-step wall-clock statistics, synchronizing on a tree
  when asked.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_sync(tree: Any) -> None:
    """Wait for the card when any tensor leaf of ``tree`` lies on one."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in _leaves(tree)):
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str = "runs/profile"):
    """``torch.profiler`` around the block (CUDA activity when a card is
    present); writes ``logdir/trace.json`` as a Chrome trace on exit and
    yields the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / "trace.json"))


annotate = record_function


class StepTimer:
    """Rolling per-step timing: mean/p50/p90, steps/s, samples/s."""

    def __init__(self, window: int = 200):
        self.window = window
        self._durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on: Any = None) -> float:
        if sync_on is not None:
            device_sync(sync_on)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self._durations.append(dt)
        if len(self._durations) > self.window:
            self._durations.pop(0)
        return dt

    @contextlib.contextmanager
    def step(self, sync_on: Any = None):
        self.start()
        yield
        self.stop(sync_on)

    def stats(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        if not self._durations:
            return {}
        xs = sorted(self._durations)
        n = len(xs)
        mean = sum(xs) / n
        stats = {
            "steps_timed": n,
            "step_ms_mean": mean * 1e3,
            "step_ms_p50": xs[n // 2] * 1e3,
            "step_ms_p90": xs[min(int(n * 0.9), n - 1)] * 1e3,
            "steps_per_sec": 1.0 / mean if mean > 0 else float("inf"),
        }
        if batch_size:
            stats["samples_per_sec"] = batch_size / mean
        return stats


__all__ = ["StepTimer", "annotate", "device_sync", "trace"]
