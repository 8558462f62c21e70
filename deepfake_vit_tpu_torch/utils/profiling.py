"""Profiling hooks of the port.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``device_sync(tree)``: waits for the card when any tensor of ``tree`` is
  on a CUDA device (``torch.cuda.synchronize``; CPU tensors need no wait);
- ``trace(logdir)``: ``torch.profiler`` over the CPU and, when there is a
  card, CUDA activity, writing a Chrome trace (``trace.json`` under
  ``logdir``, readable by Perfetto and ``chrome://tracing``); the profile
  is yielded, so its ``key_averages()`` can be read after the block;
- ``annotate(name)``: a named range in the trace
  (``record_function``) while ``torch.profiler`` records, else a shared
  no-op context: the port's spans (``serve.*`` in ``e2e.FusedPipeline``,
  ``classify.attention`` in both classifier families) cost nothing when
  nothing records;
- ``device_work(events)``: the rows of a profile that are work on the card
  (kernels, copies, memsets), without the device rows of ranges, so that a
  sum of device time counts each kernel once;
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


_NO_RANGE = contextlib.nullcontext()


def annotate(name: str):
    """A ``record_function`` range ``name`` while the profiler records, else
    one shared no-op context: the gate is the profiler's own state. Entered
    with no profiler running, a ``record_function`` still costs some 12 µs
    of host time; the gate costs under 1 µs. The range is a user annotation
    in the profiler's trace, on the host clock its device records are
    aligned to. (A range's ``args`` string is left out: the exported trace
    does not carry it, so spans of one batch are tied by nesting.)"""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_RANGE


def device_work(events) -> list:
    """The rows of ``events`` (``prof.key_averages()`` or ``prof.events()``)
    that are work on the card: kernels, copies, memsets. A range (``annotate``,
    any ``record_function``, ``Optimizer.step#…``, ``ProfilerStep#…``) also
    shows as a device row spanning the kernels launched inside it; such a
    row is a user annotation, and is left out by that flag and by the names
    of the profile's host-side ranges."""
    events = list(events)
    ranges = {ev.key for ev in events if ev.is_user_annotation}
    return [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation and ev.key not in ranges]


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


__all__ = ["StepTimer", "annotate", "device_sync", "device_work", "trace"]
