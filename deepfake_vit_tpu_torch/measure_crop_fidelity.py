"""Crop-fidelity table: windowed-warp RMSE against the exact warp, per face-span bin.

    python -m deepfake_vit_tpu_torch.measure_crop_fidelity [--scenes 48] [--size 640]
        [--windows 160,128] [--taps legacy,uw16,int8] [--geoms block,frac]
        [--seed 20260818] [--json OUT.json] [--batch 12] [--device cuda|cpu]

The JAX package's ``scripts/measure_crop_fidelity.py``, plus ``--device``.
Single-face scenes at the serving resolution (``build_corpus``: the same
draws as the JAX script), each face's alignment transform from its drawn
landmarks to the 224² template (Umeyama, float32 on the host), and every
``w{window}-{block|frac}-{tap}`` configuration of
``ops/warp.py::warp_affine_windowed`` (on the card: the pooled or
fractional crop kernel, then the warp kernel of that tap mode; on the CPU
their plain versions) against the exact float32 warp
(``ops/warp.py::warp_affine``, on the host). Faces are binned by the span
of their source quad; RMSE in grey levels per bin and pooled, one line a
configuration, and with ``--json`` the table, the spans and the seconds of
each configuration.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

BINS = ((0.0, 130.0), (130.0, 200.0), (200.0, 1e9))
BIN_LABELS = ("<130px", "130-200px", ">200px")


def quad_span(A_inv, out_size):
    """Max bbox side of the source quad (what sets the window geometry's level)."""
    Ho, Wo = out_size
    corners = np.asarray([[0, 0], [Wo - 1, 0], [0, Ho - 1], [Wo - 1, Ho - 1]], np.float32)
    src = corners @ A_inv[:, :2, :2].transpose(0, 2, 1) + A_inv[:, None, :, 2]
    wh = src.max(axis=1) - src.min(axis=1)
    return wh.max(axis=1)


def build_corpus(rng, n_scenes: int, size: int):
    """Single-face scenes with spans spread across the three bins."""
    from .data.synth_faces import render_scene

    # Head half-width ranges that land the warp quad in each span bin at
    # 640² (span ~ 1.4 × half-width after the Umeyama fit to the landmarks).
    per_bin = n_scenes // 3
    ranges = [(40, 86), (96, 138), (150, 260)]
    images, kps_list = [], []
    for lo, hi in ranges:
        got = 0
        while got < per_bin:
            img, boxes, kps = render_scene(rng, size=size, max_faces=1, min_face=lo,
                                           max_face=hi, p_empty=0.0)
            if not len(boxes):
                continue
            images.append(img)
            kps_list.append(kps[0])
            got += 1
    return np.stack(images).astype(np.float32), np.stack(kps_list)


def configurations(windows: Sequence[int], geoms: Sequence[str], taps: Sequence[str]) -> List[tuple]:
    return [(w, g, t) for w in windows for g in geoms for t in taps]


def fidelity(images: np.ndarray, kps: np.ndarray, configs: Sequence[tuple], device=None,
             batch: int = 12, keep_outputs: bool = False) -> Dict[str, Any]:
    """RMSE of each (window, geom, tap) configuration against the exact warp."""
    from .device import resolve_device
    from .ops.umeyama import invert_affine, umeyama
    from .ops.warp import warp_affine, warp_affine_windowed
    from .preprocessing.aligner import FaceAligner

    dev = resolve_device(device)
    n = len(images)
    ref = torch.as_tensor(FaceAligner(output_size=(224, 224), device="cpu").reference)
    tf = umeyama(torch.as_tensor(kps, dtype=torch.float32), ref.expand(n, 5, 2))
    spans = quad_span(invert_affine(tf).numpy(), (224, 224))
    bin_idx = np.digitize(spans, [b[0] for b in BINS[1:]])
    imgs = torch.as_tensor(images)
    exact = warp_affine(imgs, tf, (224, 224)).numpy()

    def binned_rmse(out: np.ndarray) -> Dict[str, float]:
        err2 = ((out - exact) ** 2).reshape(n, -1).mean(axis=1)
        rmse = {BIN_LABELS[i]: float(np.sqrt(err2[bin_idx == i].mean())) if (bin_idx == i).any()
                else float("nan") for i in range(3)}
        return {**rmse, "pooled": float(np.sqrt(err2.mean()))}

    imgs_dev, tf_dev = imgs.to(dev), tf.to(dev)
    results, seconds, outputs = {}, {}, {}
    for window, geom, tap in configs:
        key = f"w{window}-{geom}-{tap}"
        t0 = time.perf_counter()
        out = torch.cat([warp_affine_windowed(imgs_dev[s:s + batch], tf_dev[s:s + batch],
                                              (224, 224), window=window,
                                              fractional=(geom == "frac"),
                                              tap_construction=tap)
                         for s in range(0, n, batch)]).cpu().numpy()
        seconds[key] = time.perf_counter() - t0
        results[key] = binned_rmse(out)
        if keep_outputs:
            outputs[key] = out
    res = {"scenes": n, "spans": spans.tolist(),
           "bin_counts": {BIN_LABELS[i]: int((bin_idx == i).sum()) for i in range(3)},
           "results": results, "seconds": seconds}
    if keep_outputs:
        res["outputs"] = outputs
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Crop-fidelity table: windowed-warp RMSE vs the "
                                 "exact warp, per face-span bin (PyTorch port)")
    ap.add_argument("--scenes", type=int, default=48)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--windows", type=str, default="160,128")
    ap.add_argument("--taps", type=str, default="legacy,uw16,int8")
    ap.add_argument("--geoms", type=str, default="block,frac")
    ap.add_argument("--seed", type=int, default=20260818)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--batch", type=int, default=12, help="scenes per call")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    images, kps = build_corpus(np.random.default_rng(args.seed), args.scenes, args.size)
    print(f"corpus: {len(images)} single-face scenes @ {args.size}^2", file=sys.stderr)
    configs = configurations([int(w) for w in args.windows.split(",")], args.geoms.split(","),
                             args.taps.split(","))
    res = fidelity(images, kps, configs, args.device, args.batch)
    print("bin counts:", res["bin_counts"], file=sys.stderr)
    for key, row in res["results"].items():
        cells = "  ".join(f"{k}={v:.2f}" for k, v in row.items())
        print(f"{key:22s} {cells}   [{res['seconds'][key]:.2f}s]", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps({"size": args.size, **res}, indent=2))
        print(f"wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
