"""Isolated detect-stage timing: S2D-Lite against SCRFD at 320².

    python -m deepfake_vit_tpu_torch.probe_lite_detect [BATCH] [--iters 10] [--warmup 2]
        [--device cuda|cpu]

The JAX package's ``scripts/probe_lite_detect.py``, plus ``--device``:
for each family (``scrfd``, ``lite``), the detect stage of
``FusedPipeline`` alone (``_canvas`` and ``_detect``: the network, anchor
decode and best-face selection, bf16, the committed weights) on frames
drawn on the device (uniform 0-255 float32 at 320², the detection canvas,
so no pool folds into the stem), host ms a call over synchronized
iterations, with the family's parameter count. A family that fails is
recorded and the run exits 1 after the other.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import torch


def probe(batch: int = 256, iters: int = 10, warmup: int = 2, device=None) -> Dict[str, Any]:
    from .configs import MODEL_CONFIG
    from .device import resolve_device
    from .e2e import FusedPipeline
    from .profile_e2e import time_ms

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    det_frames = torch.rand((batch, 320, 320, 3), generator=gen, device=dev) * 255.0
    results: Dict[str, Any] = {}
    for arch in ("scrfd", "lite"):
        try:
            pipe = FusedPipeline(MODEL_CONFIG, detection_input_size=(320, 320),
                                 serving_size=(320, 320), confidence_threshold=0.0,
                                 detector_arch=arch, device=dev)
            pipe.load_variables(seed=0)
            with torch.inference_mode():
                ms = time_ms(lambda: pipe._detect(pipe._canvas(det_frames.to(pipe.dtype))),
                             dev, iters, warmup)
            n_params = sum(p.numel() for p in pipe.detector.parameters())
            results[arch] = {"ms": ms, "params": n_params}
            print(f"{arch}: {ms:.3f} ms @ b{batch} ({n_params / 1e6:.2f}M params)", flush=True)
            del pipe
        except Exception as e:  # recorded; the run exits 1 after the other family
            msg = str(e).splitlines()[0][:200] if str(e) else ""
            results[arch] = {"error": f"{type(e).__name__}: {msg}"}
            print(f"{arch}: FAILED ({type(e).__name__}: {msg})", flush=True)
    failed = [k for k, v in results.items() if "error" in v]
    return {"batch": batch, "results": results, "failed": failed}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Isolated detect-stage timing: S2D-Lite vs SCRFD "
                                 "at 320² (PyTorch port)")
    ap.add_argument("batch", type=int, nargs="?", default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    res = probe(args.batch, args.iters, args.warmup, args.device)
    print(json.dumps(res))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
