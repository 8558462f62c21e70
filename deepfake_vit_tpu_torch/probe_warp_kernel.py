"""Isolated warp and crop kernel timings per tap construction.

    python -m deepfake_vit_tpu_torch.probe_warp_kernel [--batch 128] [--window 160]
        [--iters 20] [--warmup 3] [--skip-crop] [--skip-warp] [--device cuda|cpu]

The JAX package's ``scripts/probe_warp_kernel.py``, plus ``--device``.
Times, in one process and one protocol (host ms a call, synchronized,
after warm-up calls):

- the warp kernel on window-shaped crops (N × w × w × 3 bf16 → 224²,
  window→224² affines with mild scale and rotation) for each tap mode:
  ``legacy``, ``uw``, ``uw16`` and ``int8``
  (``ops/warp_kernel.py::warp_affine_*``);
- the pooled crop (``crop_pool``; the JAX constructions ``legacy`` and
  ``mxu`` are one function here, timed under both names) and the
  fractional crop (``crop_frac`` for ``legacy``, ``crop_frac_mxu`` for
  ``mxu``) on 640² frames with face spans of 40-400 px.

A mode that fails is printed with its error and recorded in the JSON line
(last); the others still run, and then the run exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _timed(fn: Callable[[], Any], device: torch.device, iters: int, warmup: int) -> float:
    from .profile_e2e import sync, time_ms

    t0 = time.perf_counter()
    fn()
    sync(device)
    print(f"    first call {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    return time_ms(fn, device, iters, warmup)


def warp_inputs(N: int, w: int, rng, device):
    """bf16 window crops and window→224² inverse affines (mild scale and rotation)."""
    crops = torch.as_tensor(rng.uniform(0, 255, (N, w, w, 3)), dtype=torch.float32).to(
        device, torch.bfloat16)
    th = rng.uniform(-0.3, 0.3, N)
    sc = (w - 10) / 224.0
    Ms = np.zeros((N, 2, 3), np.float32)
    Ms[:, 0, 0] = sc * np.cos(th)
    Ms[:, 0, 1] = -sc * np.sin(th)
    Ms[:, 1, 0] = sc * np.sin(th)
    Ms[:, 1, 1] = sc * np.cos(th)
    Ms[:, :, 2] = 4.0
    return crops, torch.as_tensor(Ms, device=device)


def crop_inputs(N: int, H: int, W: int, rng, device):
    """bf16 (N, H, W·3) frames of integers and face-span inverse affines."""
    frames = torch.as_tensor(rng.integers(0, 256, (N, H, W * 3)), dtype=torch.float32).to(
        device, torch.bfloat16)
    spans = rng.uniform(40, 400, N).astype(np.float32)
    Ainv = np.zeros((N, 2, 3), np.float32)
    Ainv[:, 0, 0] = spans / 223.0
    Ainv[:, 1, 1] = spans / 223.0
    Ainv[:, 0, 2] = rng.uniform(0, W - spans - 1, N)
    Ainv[:, 1, 2] = rng.uniform(0, H - spans - 1, N)
    return frames, torch.as_tensor(Ainv, device=device)


def probe(batch: int = 128, window: int = 160, iters: int = 20, warmup: int = 3,
          skip_crop: bool = False, skip_warp: bool = False, device=None) -> Dict[str, Any]:
    """ms a call of every mode (or its error) and the failures' labels."""
    from .device import resolve_device
    from .ops import warp_kernel as wk
    from .ops.warp import (frac_window_levels, max_window_levels, window_geometry,
                           window_geometry_frac)

    dev = resolve_device(device)
    N, w = batch, window
    rng = np.random.default_rng(0)
    results: Dict[str, Any] = {}

    def attempt(label: str, fn: Callable[[], Any]) -> None:
        try:
            ms = _timed(fn, dev, iters, warmup)
            results[label] = {"ms": ms}
            print(f"{label}: {ms:.4f} ms", flush=True)
        except Exception as e:  # recorded; the run exits 1 after the rest
            msg = str(e).splitlines()[0][:200] if str(e) else ""
            results[label] = {"error": f"{type(e).__name__}: {msg}"}
            print(f"{label}: FAILED ({type(e).__name__}: {msg})", flush=True)

    if not skip_warp:
        crops, A = warp_inputs(N, w, rng, dev)
        for mode, fn in wk.WARP_KERNELS.items():
            attempt(f"warp_affine b{N} w{w} {mode}",
                    lambda fn=fn: fn(crops, A, (224, 224), inverse=True))
        del crops
    if not skip_crop:
        H = W = 640
        frames, Ainv = crop_inputs(N, H, W, rng, dev)
        idx = torch.arange(N, device=dev)
        levels = max_window_levels((H, W), w)
        level, y0s, x0s, _ = window_geometry(Ainv, (224, 224), (H, W), w, levels, y_align=16)
        x0_sel = x0s[level.long(), idx]
        y0_l0 = y0s[level.long(), idx] << level
        for mode in ("legacy", "mxu"):  # one function for both constructions
            attempt(f"crop_pool b{N} w{w} {mode}",
                    lambda: wk.crop_pool(frames, y0_l0, x0_sel, level, w, 3))
        lvl, strip0s, r, off_y, x0f, _ = window_geometry_frac(
            Ainv, (224, 224), (H, W), w, frac_window_levels(H, w), y_align=16)
        strip0 = strip0s[lvl.long(), idx]
        for mode, fn in (("legacy", wk.crop_frac), ("mxu", wk.crop_frac_mxu)):
            attempt(f"crop_frac b{N} w{w} {mode}",
                    lambda fn=fn: fn(frames, strip0, lvl, r, off_y, x0f, w, 3))
    failed = [k for k, v in results.items() if "error" in v]
    return {"batch": N, "window": w, "results": results, "failed": failed}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Isolated warp/crop kernel timings per tap "
                                 "construction (PyTorch port)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--window", type=int, default=160)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--skip-crop", action="store_true")
    ap.add_argument("--skip-warp", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    res = probe(args.batch, args.window, args.iters, args.warmup, args.skip_crop,
                args.skip_warp, args.device)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
