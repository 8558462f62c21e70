"""Timing of the cascade refiner: FaceDetector with refine off and on.

    python -m deepfake_vit_tpu_torch.probe_refine_timing [--batch 128] [--iters 20]
        [--warmup 3] [--device cuda|cpu]

The JAX package's ``scripts/probe_refine_timing.py`` (B = 128 fixed
there), plus ``--batch``, ``--iters``, ``--warmup`` and ``--device``:
``FaceDetector``'s one-call detect graph (``_detect_graph``: network,
decode, NMS and, with ``refine=True``, the 64² refiner on the top 4
proposals of each frame) at the 320² canvas, float32, on seeded uint8
frames on the device, host ms a call over synchronized iterations, and
the refine stage's delta. A setting that fails is recorded and the run
exits 1 after the other.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def probe(batch: int = 128, iters: int = 20, warmup: int = 3, device=None) -> Dict[str, Any]:
    from .device import resolve_device
    from .preprocessing.detector import FaceDetector
    from .profile_e2e import time_ms

    dev = resolve_device(device)
    print(f"device: {dev}", file=sys.stderr)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, 320, 320, 3), dtype=np.uint8)).to(dev)
    results: Dict[str, Any] = {}
    for refine in (False, True):
        key = f"refine={refine}"
        try:
            det = FaceDetector(confidence_threshold=0.3, input_size=(320, 320), refine=refine,
                               device=dev)
            ms = time_ms(lambda: det._detect_graph(frames), dev, iters, warmup)
            results[key] = {"ms": ms, "frames_per_s": batch / ms * 1e3}
            print(f"{key}: {ms:.2f} ms @ b{batch} ({batch / ms * 1e3:.0f} frames/s)", flush=True)
        except Exception as e:  # recorded; the run exits 1 after the other setting
            msg = str(e).splitlines()[0][:200] if str(e) else ""
            results[key] = {"error": f"{type(e).__name__}: {msg}"}
            print(f"{key}: FAILED ({type(e).__name__}: {msg})", flush=True)
    failed = [k for k, v in results.items() if "error" in v]
    out: Dict[str, Any] = {"batch": batch, "results": results, "failed": failed}
    if not failed:
        d = results["refine=True"]["ms"] - results["refine=False"]["ms"]
        out["refine_delta_ms"] = d
        print(f"refine stage delta: {d:+.2f} ms @ b{batch} ({d / batch * 1e3:.1f} us/frame, "
              f"top_k=4 -> {batch * 4} crops re-scored)", flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Timing of the cascade refiner (PyTorch port)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    res = probe(args.batch, args.iters, args.warmup, args.device)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
