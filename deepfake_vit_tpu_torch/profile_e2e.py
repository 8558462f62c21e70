"""Per-stage profile of the headline serving path (640² frames, 320² detection).

    python -m deepfake_vit_tpu_torch.profile_e2e [BATCH] [--sweep] [--iters 10]
        [--warmup 2] [--device cuda|cpu]

The JAX package's ``scripts/profile_e2e.py``, plus ``--device``. It builds
the headline pipeline (``bench.py::_build_headline``: int8 detector and
int8 tail from block 10 with calibrated static scales, fractional
window-128 warp, 192² faces, bf16, the committed detector weights, a
seeded B4; the calibration runs on the pipeline's device) and times each
stage of ``FusedPipeline._graph`` on its own, through the pipeline's own
stage methods, which composed compute what ``forward`` computes:

- ``canvas``: the cast of the uint8 frames and ``_canvas`` (the JAX
  script's pool stage; the last 2× pool rides the detector's folded first
  convolution, so at 640² → 320² this is the cast and the normalization),
- ``detect_320`` / ``detect_320_int8``: ``_detect`` with the bf16 network
  and with the int8 graph (decode and best-face selection included),
- ``align_warp_640``: ``_to_serving`` and ``_align`` (Umeyama, the
  fractional crop kernel and the warp kernel),
- ``quality``: ``_quality``,
- ``classify_b{B}``: ``_classify`` (normalization, the bf16 blocks, the
  int8 tail, attention, head, softmax),
- ``e2e_fused``: ``forward``.

Each stage gets its host ms over ``--iters`` synchronized calls after
``--warmup`` and, on the card, its own device ms: the sum of the kernels
one call launches, from ``torch.profiler`` (``device_ms_of``), and its
kernel launches (the wrappers' counts) in one call. ``--sweep``
adds classify at B = 64, 128 and 256 on drawn-at-random faces. Numbers go
to stderr; one JSON summary to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

SERVING, DETECT, WINDOW, FACE, TAIL_START = (640, 640), (320, 320), 128, (192, 192), 10


def headline_pipeline(device=None, model_config: Optional[Dict[str, Any]] = None,
                      dtype: torch.dtype = torch.bfloat16, calibrate: bool = True, **overrides):
    """The headline configuration (``bench.py::_build_headline``), weights
    loaded (seed 0) and, with ``calibrate``, its static int8 scales
    calibrated on the pipeline's device as the JAX benchmark calibrates
    them (8 uniform-noise faces, 4 uniform-noise frames, seeded)."""
    from .configs import MODEL_CONFIG
    from .e2e import FusedPipeline

    kw = dict(detection_input_size=DETECT, serving_size=SERVING, confidence_threshold=0.0,
              use_int8_tail=True, int8_tail_start=TAIL_START, warp_window=WINDOW,
              warp_fractional=True, use_int8_detector=True, output_size=FACE, dtype=dtype,
              device=device)
    kw.update(overrides)
    pipe = FusedPipeline(model_config or MODEL_CONFIG, **kw)
    pipe.load_variables(seed=0)
    if calibrate and pipe.use_int8_tail:
        pipe.calibrate_int8(np.random.default_rng(1).uniform(0, 255, (8, *pipe.output_size, 3)),
                            batch_size=8)
    if calibrate and pipe.use_int8_detector:
        pipe.calibrate_int8_detector(
            np.random.default_rng(2).uniform(0, 255, (4, *pipe.serving_size, 3))
            .astype(np.float32))
    return pipe


def counted_kernels() -> list:
    """Every kernel wrapper of the port, each with its ``launches`` count."""
    from .ops import fused_mbconv as fm
    from .ops import fused_stages as fs
    from .ops import int8_kernel as ik
    from .ops import warp_kernel as wk

    return [wk.crop_frac, wk.crop_frac_mxu, wk.crop_pool, wk.warp_affine_legacy,
            wk.warp_affine_uw, wk.warp_affine_uw16, wk.warp_affine_int8, ik.int8_gemm,
            ik.int8_conv, fs.run_stem, fs.run_block, fm.fused_mbconv]


def launches_of(fn: Callable[[], Any]) -> Dict[str, int]:
    """Kernel launches of one call of ``fn`` (counts zeroed first; zeros left out)."""
    kernels = counted_kernels()
    for k in kernels:
        k.launches = 0
    fn()
    return {k.__name__: k.launches for k in kernels if k.launches}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn: Callable[[], Any], device: torch.device, iters: int = 10,
            warmup: int = 2) -> float:
    """Host ms a call over ``iters`` calls after ``warmup``, synchronized."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


@torch.inference_mode()
def staged_state(pipe, frames: torch.Tensor) -> Dict[str, Any]:
    """The pipeline's stages one by one, as ``_detect_align`` runs them:
    every intermediate, and the state ``_classify`` takes (``state``)."""
    x = frames.to(pipe.dtype)
    canvas = pipe._canvas(x)
    det = pipe._detect(canvas)
    bbox, lms = pipe._to_serving(det["bbox"], det["landmarks"])
    aligned, aligned_lms = pipe._align(x, lms, det["frame_idx"])
    quality, q_valid = pipe._quality(aligned, aligned_lms, bbox, det["confidence"])
    state = {"B": frames.shape[0], "has_face": det["has_face"], "confidence": det["confidence"],
             "bbox": bbox, "aligned": aligned, "landmarks": aligned_lms, "quality": quality,
             "quality_valid": q_valid}
    return {"x": x, "canvas": canvas, "det": det, "lms": lms, "state": state}


def stage_fns(pipe, frames: torch.Tensor) -> Dict[str, Callable[[], Any]]:
    """One closure a stage, each on the previous stages' outputs (computed
    once by ``staged_state``), and the whole ``forward``."""
    st = staged_state(pipe, frames)
    x, canvas, det, state = st["x"], st["canvas"], st["det"], st["state"]
    fns = {
        "canvas": lambda: pipe._canvas(frames.to(pipe.dtype)),
        "detect_320": lambda: pipe._detect(canvas, int8=False),
        "align_warp_640": lambda: pipe._align(
            x, pipe._to_serving(det["bbox"], det["landmarks"])[1], det["frame_idx"]),
        "quality": lambda: pipe._quality(state["aligned"], state["landmarks"], state["bbox"],
                                         state["confidence"]),
        f"classify_b{frames.shape[0]}": lambda: pipe._classify(state),
        "e2e_fused": lambda: pipe.forward(frames),
    }
    if pipe.use_int8_detector:
        fns["detect_320_int8"] = lambda: pipe._detect(canvas, int8=True)
    return fns


def device_ms_of(fn: Callable[[], Any], device: torch.device, sessions: int = 2) -> float:
    """The device time of the kernels one call of ``fn`` launches, from
    ``torch.profiler``: the larger sum of ``sessions`` profiled calls
    (the profiler now and then loses records late in a long process)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    best = 0.0
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            sync(device)
        best = max(best, sum(ev.self_device_time_total for ev in prof.key_averages()
                             if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3)
    return best


def profile(pipe, frames: torch.Tensor, iters: int = 10, warmup: int = 2,
            sweep: bool = False) -> Dict[str, Any]:
    """Host ms, device ms (on the card) and launches of every stage."""
    frames = torch.as_tensor(frames).to(pipe.device)
    fns = stage_fns(pipe, frames)
    host = {}
    for name, fn in fns.items():
        with torch.inference_mode():
            host[name] = time_ms(fn, pipe.device, iters, warmup)
        print(f"{name}: {host[name]:.3f} ms ({frames.shape[0] / host[name] * 1e3:.0f}/s)",
              file=sys.stderr)
    with torch.inference_mode():
        launches = {name: launches_of(fn) for name, fn in fns.items()}
    out = {"batch": int(frames.shape[0]), "host_ms": host, "launches": launches}
    if pipe.device.type == "cuda":
        with torch.inference_mode():
            out["device_ms"] = {name: device_ms_of(fn, pipe.device) for name, fn in fns.items()}
        for name, ms in out["device_ms"].items():
            print(f"  device {name}: {ms:.3f} ms", file=sys.stderr)
    if sweep:
        out["classify_sweep"] = classify_sweep(pipe, iters, warmup)
    return out


def classify_sweep(pipe, iters: int = 10, warmup: int = 2, batches=(64, 128, 256)) -> Dict[str, float]:
    """``_classify`` on uniform-noise faces and landmarks at each batch."""
    rng = np.random.default_rng(0)
    res = {}
    for b in batches:
        face = pipe.output_size
        state = {"B": b, "has_face": torch.ones(b, dtype=torch.bool, device=pipe.device),
                 "confidence": torch.ones(b, device=pipe.device),
                 "bbox": torch.zeros(b, 4, device=pipe.device),
                 "aligned": torch.as_tensor(rng.uniform(0, 255, (b, *face, 3)),
                                            dtype=torch.float32, device=pipe.device),
                 "landmarks": torch.as_tensor(rng.uniform(0, face[0], (b, 5, 2)),
                                              dtype=torch.float32, device=pipe.device),
                 "quality": torch.ones(b, device=pipe.device),
                 "quality_valid": torch.ones(b, dtype=torch.bool, device=pipe.device)}
        with torch.inference_mode():
            ms = time_ms(lambda: pipe._classify(state), pipe.device, iters, warmup)
        res[f"classify_sweep_b{b}"] = ms
        print(f"classify_sweep_b{b}: {ms:.3f} ms ({b / ms * 1e3:.0f}/s)", file=sys.stderr)
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Per-stage profile of the headline pipeline "
                                 "(PyTorch port)")
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("--sweep", action="store_true", help="classify at B = 64, 128, 256")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    pipe = headline_pipeline(args.device)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (args.batch, *SERVING, 3), dtype=np.uint8))
    res = profile(pipe, frames, args.iters, args.warmup, args.sweep)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
