"""One-config serving-throughput probe for batch and warp-configuration sweeps.

    python -m deepfake_vit_tpu_torch.probe_serving [--batch 256] [--iters 10] [--warmup 2]
        [--warp-window 160] [--warp-fractional] [--no-int8] [--int8-static]
        [--int8-start N] [--warp-taps legacy|uw|uw16|int8] [--detector-arch scrfd|lite]
        [--int8-detector] [--det-static] [--sweep TOKENS] [--json OUT.jsonl]
        [--device cuda|cpu]

The JAX package's ``scripts/probe_serving.py``, plus ``--device``, without
``--options`` (XLA compiler options) and without its ``XLA_FLAGS``, which
have no counterpart here. Times ``FusedPipeline.forward`` (640² uint8
frames, 320² detection, the committed detector weights, a seeded B4, bf16)
as ``bench.py`` does (warm-up calls, then a synchronized loop) at any
batch. Static int8 scales are calibrated on the pipeline's device.

``--sweep`` serves several configurations in one process, one line each:
comma-separated tokens ``<window><b|f>[-taps][+d|+L][/oN][@batch]``
(``parse_sweep_tokens``; ``b`` the pooled 2ˡ window, ``f`` the
fractional one, ``+d`` the int8 detector with static scales, ``+L`` the
S2D-Lite detector, ``/oN`` the classified face side, ``@N`` that combo's
batch). Each combo is a fresh ``FusedPipeline`` with the same seeded
weights and the one int8 calibration; the frames are drawn once at the
largest batch and sliced. With ``--json`` each combo appends a JSON line
as it lands. A combo that fails is printed and recorded with its error,
the others still run, and then the run exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def parse_sweep_tokens(sweep: str):
    """Parse --sweep tokens: ``<window><b|f>[-taps][+d|+L][/oN][@batch]``.

    ``+d`` = int8 SCRFD detector (static scales); ``+L`` = the S2D-Lite
    detector family in place of SCRFD; mutually exclusive. ``/oN``
    overrides the aligned-face (classify input) side for that combo;
    ``@N`` overrides the serving batch for that combo only.
    Returns (window, fractional, taps, int8_det, lite, batch|None,
    out_size|None) tuples.
    """
    combos = []
    for tok in sweep.split(","):
        tok = tok.strip()
        tok, at, bat = tok.partition("@")
        if at and not bat.isdigit():
            raise SystemExit(f"bad sweep batch suffix @{bat!r}: want @<int>")
        tok, slash, osz = tok.partition("/o")
        if slash and not osz.isdigit():
            raise SystemExit(f"bad sweep face-size suffix /o{osz!r}: want /o<int>")
        lite = tok.endswith("+L")
        int8_det = tok.endswith("+d")
        if lite or int8_det:
            tok = tok[:-2]
        tok, _, taps = tok.partition("-")
        if not tok or tok[-1] not in ("b", "f") or not tok[:-1].isdigit():
            raise SystemExit(
                f"bad sweep token {tok!r}: want "
                "<window><b|f>[-taps][+d|+L][/oN][@batch]"
            )
        combos.append((int(tok[:-1]), tok[-1] == "f", taps or "legacy",
                       int8_det, lite, int(bat) if bat else None,
                       int(osz) if osz else None))
    return combos


def combo_label(window: int, frac: bool, taps: str, int8_det: bool, lite: bool, b: int,
                osize: Optional[int], batch: int) -> str:
    return (f"w{window}{'frac' if frac else 'block'}-{taps}"
            f"{'+int8det' if int8_det else ''}{'+lite' if lite else ''}"
            f"{f'/o{osize}' if osize else ''}{f'@b{b}' if b != batch else ''}")


def serve_ms(pipe, frames: torch.Tensor, iters: int, warmup: int) -> float:
    """ms a batch: warm-up calls, then ``iters`` calls and one synchronization."""
    from .profile_e2e import time_ms

    t0 = time.perf_counter()
    pipe.forward(frames)
    if frames.is_cuda:
        torch.cuda.synchronize()
    print(f"  first call {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    return time_ms(lambda: pipe.forward(frames), frames.device, iters, max(warmup - 1, 0))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="One-config serving-throughput probe "
                                 "(PyTorch port)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--warp-window", type=int, default=160)
    ap.add_argument("--warp-fractional", action="store_true")
    ap.add_argument("--no-int8", action="store_true")
    ap.add_argument("--int8-static", action="store_true",
                    help="calibrated static activation scales instead of dynamic per-image "
                    "scales (calibrates on uniform-noise faces)")
    ap.add_argument("--int8-start", type=int, default=None,
                    help="first quantized flat block (default: stage 4)")
    ap.add_argument("--warp-taps", type=str, default="legacy",
                    choices=["legacy", "uw", "uw16", "int8"])
    ap.add_argument("--detector-arch", type=str, default="scrfd", choices=["scrfd", "lite"])
    ap.add_argument("--int8-detector", action="store_true",
                    help="the SCRFD forward through the s8 convolution kernel, dynamic scales")
    ap.add_argument("--det-static", action="store_true",
                    help="with --int8-detector: static calibrated activation scales")
    ap.add_argument("--sweep", type=str, default=None,
                    help="same-process sweep of <window><b|f>[-taps][+d|+L][/oN][@batch] "
                    "combos, comma-separated")
    ap.add_argument("--json", type=str, default=None,
                    help="with --sweep: append one JSON line per combo to this path")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from .configs import MODEL_CONFIG
    from .device import resolve_device
    from .e2e import FusedPipeline

    dev = resolve_device(args.device)
    print(f"device: {dev}", file=sys.stderr)
    common = dict(detection_input_size=(320, 320), serving_size=(640, 640),
                  confidence_threshold=0.0, device=dev)
    sweep_combos = parse_sweep_tokens(args.sweep) if args.sweep else []
    pipe = FusedPipeline(MODEL_CONFIG, use_int8_tail=not args.no_int8,
                         int8_tail_start=args.int8_start, warp_window=args.warp_window,
                         warp_fractional=args.warp_fractional, warp_tap_mode=args.warp_taps,
                         use_int8_detector=args.int8_detector, detector_arch=args.detector_arch,
                         **common)
    pipe.load_variables(seed=0)
    if args.int8_static and not args.no_int8:
        t_cal = time.perf_counter()
        pipe.calibrate_int8(np.random.default_rng(1).uniform(0, 255, (8, *pipe.output_size, 3))
                            .astype(np.float32), batch_size=8)
        print(f"calibrated static int8 scales in {time.perf_counter() - t_cal:.1f} s",
              file=sys.stderr)
    det_scales = None
    if args.det_static or any(c[3] for c in sweep_combos):
        t_cal = time.perf_counter()
        cal_frames = np.random.default_rng(2).uniform(0, 255, (4, 640, 640, 3)).astype(np.float32)
        cal = FusedPipeline(MODEL_CONFIG, use_int8_detector=True, **common)
        cal.load_variables(seed=0)
        det_scales = cal.calibrate_int8_detector(cal_frames)
        del cal
        if args.det_static:
            pipe.det_act_scales = det_scales
            pipe.build_runners()
        print(f"calibrated static int8 detector scales in {time.perf_counter() - t_cal:.1f} s",
              file=sys.stderr)

    max_batch = max([args.batch] + [c[5] for c in sweep_combos if c[5]])
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (max_batch, 640, 640, 3), dtype=np.uint8)).to(dev)

    if not args.sweep:
        ms = serve_ms(pipe, frames[:args.batch], args.iters, args.warmup)
        print(f"e2e b{args.batch} w{args.warp_window}: {args.batch / ms * 1e3:.1f} faces/s "
              f"({ms:.2f} ms/step)")
        print(json.dumps({"batch": args.batch, "window": args.warp_window, "ms": ms,
                          "faces_per_sec": args.batch / ms * 1e3}))
        return 0

    def emit(rec: Dict[str, Any]) -> None:
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())

    failed: List[str] = []
    records: List[Dict[str, Any]] = []
    tail_scales = pipe.int8_act_scales
    del pipe
    for window, frac, taps, int8_det, lite, cbatch, osize in sweep_combos:
        b = cbatch or args.batch
        label = combo_label(window, frac, taps, int8_det, lite, b, osize, args.batch)
        rec: Dict[str, Any] = {"label": label, "window": window, "fractional": frac,
                               "taps": taps, "int8_detector": int8_det, "lite": lite,
                               "batch": b, "out_size": osize}
        try:
            p = FusedPipeline(
                MODEL_CONFIG, use_int8_tail=not args.no_int8, int8_tail_start=args.int8_start,
                warp_window=window, warp_fractional=frac, warp_tap_mode=taps,
                # /oN combos reuse the one calibration: the scales shift a
                # little with the face size, the timing does not.
                int8_act_scales=tail_scales, use_int8_detector=int8_det,
                det_act_scales=det_scales,
                detector_arch="lite" if lite else "scrfd",
                **(dict(output_size=(osize, osize)) if osize else {}), **common)
            p.load_variables(seed=0)
            ms = serve_ms(p, frames[:b], args.iters, args.warmup)
            rec.update(ms=ms, faces_per_sec=b / ms * 1e3)
            print(f"e2e b{b} {label}: {b / ms * 1e3:.1f} faces/s ({ms:.2f} ms/step)", flush=True)
            del p
        except Exception as e:  # recorded; the run exits 1 after the other combos
            msg = str(e).splitlines()[0][:200] if str(e) else ""
            rec["error"] = f"{type(e).__name__}: {msg}"
            failed.append(label)
            print(f"e2e b{b} {label}: FAILED ({rec['error']})", flush=True)
        emit(rec)
        records.append(rec)
    print(json.dumps({"combos": records, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
