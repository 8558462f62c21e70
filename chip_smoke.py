"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds the CUDA kernels from ``deepfake_vit_tpu_torch/csrc`` (one nvcc
   per source, in parallel).
3. Holds each of the twelve kernels against its plain PyTorch version at
   the serving paths' shapes and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (``F.grid_sample``,
   ``torch._int_mm``: yardsticks the port never calls) with CUDA events:
   the median and range of several repeats of a wrapper call, which
   include the host's enqueue time when the host is slower than the card.
   Beside them each kernel's and each library call's own device time from
   ``torch.profiler`` over the same launches (``device_ms``,
   ``library_device_ms``): the numbers to compare a kernel with its
   library call and its bound. The crop and GEMM wrappers must launch
   exactly one device kernel a call. The GEMM gets K-major weights, as the
   int8 tail keeps them; ``torch._int_mm`` is timed on those and on
   row-major weights and the faster stands as the library call; a fill of
   the f32 output is printed as the store floor. The two int8 kernels must
   agree bit for bit, the seven crop and warp kernels (the fractional crop with
   legacy and rank-1 "mxu" taps, the pooled crop, the warp with legacy,
   "uw", "uw16" and int8 taps) within one bf16 step (they agree bit for
   bit), "uw" and "uw16" with each other bit for bit, the fused stem,
   MBConv block and single-block prototype within two bf16 steps of the
   value (their 1×1 products sum in another order than the plain
   versions'); the share of elements that differ at all is printed.
4. Checks each pipeline on the card against the same pipeline on the CPU
   (plain kernel versions, float32) on two frames with drawn faces (three
   faces of different sizes a frame for the multi-face path).
5. Serves seven paths for a few batches at B = 32 and B = 128, twice, in
   turns (A, B, bf16, C, D, E, F, then back) — all EfficientNet-B4 at full
   width and depth (seeded weights), committed detector weights, 320²
   detection on 640² uint8 frames, bf16 — with every kernel's launch count
   reset just before and read just after each:
   * path A, the headline: int8 detector and int8 tail from block 10 with
     calibrated static scales, fractional window-128 warp, 192² faces;
   * path B, the class default: pooled window-160 warp, 224² faces;
   * the bf16 headline geometry of the first slice (both int8 options off);
   * path C, the fused backbone: the bf16 headline geometry with
     ``use_fused_backbone`` — stem and blocks 0-9 through the fused kernels;
   * path D, the class default with ``use_fused_backbone`` (224² faces:
     stem and blocks 0-21), at B = 32 only;
   * path E, the int8-tap headline: path A with ``warp_tap_mode="int8"``
     (rank-1 "mxu" crop, int8 warp);
   * path F, multi-face serving: the class default geometry with the lite
     detector, ``keep_top_k=3`` and ``warp_tap_mode="uw16"``, at B = 32
     only (96 faces a batch).
   Then drives what no pipeline runs: the single-block prototype on two B4
   block shapes, held to the unfused module, and the "uw" warp through
   ``warp_affine_windowed(tap_construction="uw")``, held to "uw16".
6. Where the serving time goes: one batch per path and size under
   ``torch.profiler`` — device busy time against the batch time (the idle
   share), device time by kernel class, top kernels.

Prints one JSON line with the kernels' numbers, then
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero without a
card, when a kernel does not build or disagrees, or when any check fails.
Writes the same numbers and the profile to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
SERVING, DETECT, WINDOW, FACE = (640, 640), (320, 320), 128, (192, 192)
POOL_WINDOW, POOL_FACE = 160, (224, 224)  # FusedPipeline's default warp and face size
TAIL_START = 10
BATCH, N_BATCHES = 32, 4
PROFILE_BATCHES = (BATCH, 128)
# Kernel vs plain version: both apply the same rounding points, so they
# agree bit for bit; the limit is one bf16 ulp of a [128, 256) pixel. The
# int8 products have exact s32 sums: no difference at all is allowed.
CROP_TOL, WARP_TOL, POOL_TOL, INT8_TOL = 1.0, 1.0, 1.0, 0.0
# The fused kernels sum their 1x1 products in another order than the plain
# versions: two bf16 steps of the value, |k - p| <= FUSED_TOL * max(|p|, 1).
FUSED_TOL = 2.0 ** -7
FUSED_FEATURES_REL = 1e-2  # card vs CPU, fused paths: max |Δfeatures| / max |features|
MULTI_K = 3  # path F's keep_top_k
# Launches per served batch: 22 tail blocks x (expand, project); 1 + 12 + 3
# + 3 + 6 detector convs; one crop and one warp; the stem and one launch
# group (three device launches) per fused block: blocks 0-9 at 192² faces,
# 0-21 at 224². Every kernel not named launches 0 times.
KERNEL_NAMES = ("crop_frac", "crop_frac_mxu", "crop_pool", "warp_affine_legacy",
                "warp_affine_uw", "warp_affine_uw16", "warp_affine_int8", "int8_gemm",
                "int8_conv", "run_stem", "run_block", "fused_mbconv")
_INT8 = {"int8_gemm": 44, "int8_conv": 25}
EXPECTED = {path: {**dict.fromkeys(KERNEL_NAMES, 0), **counts} for path, counts in {
    "A int8 headline": {**_INT8, "crop_frac": 1, "warp_affine_legacy": 1},
    "B default pooled warp": {"crop_pool": 1, "warp_affine_legacy": 1},
    "bf16 headline geometry": {"crop_frac": 1, "warp_affine_legacy": 1},
    "C fused backbone": {"crop_frac": 1, "warp_affine_legacy": 1, "run_stem": 1, "run_block": 10},
    "D fused backbone, default geometry": {"crop_pool": 1, "warp_affine_legacy": 1,
                                           "run_stem": 1, "run_block": 22},
    "E int8-tap headline": {**_INT8, "crop_frac_mxu": 1, "warp_affine_int8": 1},
    "F multi-face, lite detector": {"crop_pool": 1, "warp_affine_uw16": 1},
}.items()}
# Batch sizes each path is served at (and profiled at, in the first round).
PATH_BATCHES = {path: (BATCH,) if path.startswith(("D", "F")) else PROFILE_BATCHES
                for path in EXPECTED}
# Fused-kernel shapes of phase 3: (flat B4 block index, input size, batch).
# Blocks 1-7 at the 192² path's resolutions; block 17 at 14² is the widest
# block of the 224² path (cexp 960).
FUSED_BLOCKS = ((1, 96, 128), (2, 96, 128), (3, 48, 128), (6, 48, 128), (7, 24, 128),
                (17, 14, 32))
PROTO_BLOCKS = ((3, 48, 128), (12, 14, 128))
# GEMM shapes of the tail at B = 128 (rows = 128 x H x W): largest M, a
# mid shape, largest K. Conv shapes of the detector at the 320² canvas.
GEMM_SHAPES = ((128 * 576, 56, 336), (128 * 144, 160, 960), (128 * 36, 2688, 448))
CONV_SHAPES = (  # (name, H, Cin, Cout, k, stride)
    ("stem2 160² 32→32 s2", 160, 32, 32, 3, 2),
    ("tower 40² 64→64 s1", 40, 64, 64, 3, 1),
    ("block 10² 256→256 s1", 10, 256, 256, 3, 1),
    ("shortcut 80² 32→64 1×1 s2", 80, 32, 64, 1, 2),
)

# Kernel-name fragments → class for the profile, first match wins.
KERNEL_CLASSES = (
    ("host <-> device copy", ("memcpy",)),
    ("crop_frac (port kernel)", ("crop_frac_band_kernel<0>",)),
    ("crop_frac_mxu (port kernel)", ("crop_frac_band_kernel<1>",)),
    ("crop_pool (port kernel)", ("crop_pool_kernel",)),
    ("warp_affine_legacy (port kernel)", ("warp_bf16_kernel<0>",)),
    ("warp_affine_uw / uw16 (port kernel)", ("warp_bf16_kernel<1>",)),
    ("warp_affine_int8 (port kernel)", ("warp_int8_kernel",)),
    ("crop / warp (port kernel, construction not in the name)",
     ("crop_frac_band_kernel", "warp_bf16_kernel")),
    ("int8_gemm (port kernel)", ("int8_gemm_mma_kernel",)),
    ("int8_conv (port kernel)", ("int8_conv_kernel",)),
    ("fused_stem (port kernel)", ("fused_stem_kernel",)),
    ("fused_block (port kernel)", ("fused_block_pass_kernel", "fused_se_kernel")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "winograd", "dgrad", "fprop", "nhwc", "nchw")),
    ("matmul", ("gemm", "cutlass", "sm90", "sm80")),
    ("reduction", ("reduce", "mean", "sum", "max", "norm")),
    ("copy / layout", ("copy", "cat", "transpose", "permute", "fill", "index", "gather", "scatter")),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3, repeats: int = 7) -> dict:
    """Mean ms per call over ``iters`` calls (CUDA events), ``repeats``
    times: the median and the range."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return {"median": statistics.median(samples), "min": min(samples), "max": max(samples)}


def device_ms(fn, own: str = "", iters: int = 20, warmup: int = 3) -> dict:
    """Device time per call: ``torch.profiler`` over ``iters`` calls, each
    device kernel summed by name over the call count. Unlike ``time_ms``
    this leaves out the host's enqueue time. Returns ``ms``, the time per
    call of the kernels whose name holds ``own`` (every kernel by default),
    ``call_ms`` and ``launches``, all device time and device launches per
    call, and the per-kernel split."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):  # now and then a profile comes back without its device records
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = {ev.key: {"ms": ev.self_device_time_total / 1e3 / iters,
                            "launches": ev.count / iters}
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0}
        if kernels:
            break
        time.sleep(0.2)
    else:
        t = time_ms(fn, iters, warmup=0, repeats=3)
        print(f"device_ms: the profiler saw no device records in five tries; {t['median']:.4f} "
              f"ms from CUDA events instead (host enqueue included)")
        return {"ms": t["median"], "call_ms": t["median"], "launches": float("nan"),
                "kernels": {}, "source": "CUDA events"}
    mine = [k["ms"] for name, k in kernels.items() if own in name]
    if not mine:
        fail(f"the profiler saw no device kernel named like {own!r}: {sorted(kernels)}")
    return {"ms": sum(mine), "call_ms": sum(k["ms"] for k in kernels.values()),
            "launches": sum(k["launches"] for k in kernels.values()), "kernels": kernels}


def fmt(t: dict) -> str:
    return f"{t['median']:.4f} [{t['min']:.4f}, {t['max']:.4f}]"


def fmt_dev(d: dict) -> str:
    return (f"{d['ms']:.4f} (the call: {d['call_ms']:.4f} in {d['launches']:g} device "
            f"launches)")


@contextlib.contextmanager
def tf32_off():
    """float32 convs and matmuls without TF32; restores both flags."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def seeded_geometry(n: int, seed: int, dev):
    """dst→src similarity affines for n faces: scales spanning strip
    buckets 0..3, some r = 1 faces, centers reaching past the frame edge."""
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(np.log(0.3), np.log(3.6), n))
    s[: n // 8] = 0.4  # quad fits the window at r = 1
    th = rng.uniform(-0.35, 0.35, n)
    th[: n // 16] = 0.0
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    center = rng.uniform(-40, SERVING[0] + 40, (n, 2))
    half = np.asarray([(FACE[1] - 1) / 2, (FACE[0] - 1) / 2])
    t = center - np.einsum("nij,j->ni", R, half)
    return torch.as_tensor(np.concatenate([R, t[..., None]], -1), dtype=torch.float32, device=dev)


def nonzero_tap(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Whether tap t of coordinate s has a nonzero bf16 weight, as the
    kernels compute it: bf16(max(0, 1 − |s − t|)) > 0."""
    return (1.0 - (s - t.float()).abs()).clamp_min(0.0).to(torch.bfloat16) > 0


def crop_footprint_bytes(strip0, level, r, off_y, x0f, H, W, C) -> int:
    """Bytes the crop must read: the distinct source pixels its taps touch
    with a nonzero weight (rows inside the face's strip and the frame,
    columns inside the frame). The taps are separable, so a face reads
    the product of its distinct rows and columns."""
    N = strip0.shape[0]
    dev = strip0.device
    i = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    rows = torch.clamp_max(torch.full_like(level.long(), WINDOW) << level.long(), H)
    sy = off_y[:, None] + (i + 0.5) * r[:, None] - 0.5
    sx = x0f[:, None] + (i + 0.5) * r[:, None] - 0.5
    ty, tx = torch.floor(sy).long(), torch.floor(sx).long()
    ymask = torch.zeros((N, H + 2), dtype=torch.bool, device=dev)
    xmask = torch.zeros((N, W + 2), dtype=torch.bool, device=dev)
    for k in (0, 1):
        t = ty + k
        ok = (t >= 0) & (t < rows[:, None]) & (strip0[:, None].long() + t < H) & nonzero_tap(sy, t)
        ymask.scatter_(1, torch.where(ok, t, torch.full_like(t, H + 1)), True)
        s = tx + k
        ok = (s >= 0) & (s < W) & nonzero_tap(sx, s)
        xmask.scatter_(1, torch.where(ok, s, torch.full_like(s, W + 1)), True)
    ny = ymask[:, : H + 1].sum(1)
    nx = xmask[:, : W + 1].sum(1)
    return int((ny * nx).sum().item()) * C * 2


def warp_footprint_bytes(coeffs, Hs, Ws, C, out_size) -> int:
    """Bytes the warp must read: the distinct crop pixels that a nonzero
    2×2 tap of some output point touches (bf16)."""
    N = coeffs.shape[0]
    dev = coeffs.device
    ii = torch.arange(out_size[0], dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(out_size[1], dtype=torch.float32, device=dev)[None, :]
    a, b, c, d, e, f = (coeffs[:, k, None, None] for k in range(6))
    sx = (a * jj + b * ii + c).reshape(N, -1)  # the kernel's order
    sy = (d * jj + e * ii + f).reshape(N, -1)
    ty, tx = torch.floor(sy).long(), torch.floor(sx).long()
    mask = torch.zeros((N, Hs * Ws + 1), dtype=torch.bool, device=dev)
    for dy in (0, 1):
        t = ty + dy
        vok = (t >= 0) & (t < Hs) & nonzero_tap(sy, t)
        for dx in (0, 1):
            s = tx + dx
            ok = vok & (s >= 0) & (s < Ws) & nonzero_tap(sx, s)
            mask.scatter_(1, torch.where(ok, t * Ws + s, torch.full_like(t, Hs * Ws)), True)
    return int(mask[:, : Hs * Ws].sum().item()) * C * 2


def build_pipeline(path: str, dtype=torch.bfloat16, device=None, scales=None):
    """One of the seven served configurations. Paths A and E are calibrated
    as the JAX benchmark calibrates its headline (8 uniform-noise faces, 4
    uniform-noise frames, seeded) unless ``scales`` hands the scales over."""
    from deepfake_vit_tpu_torch.configs import MODEL_CONFIG
    from deepfake_vit_tpu_torch.e2e import FusedPipeline

    common = dict(detection_input_size=DETECT, serving_size=SERVING, confidence_threshold=0.0,
                  dtype=dtype, device=device)
    int8 = path.startswith(("A", "E"))
    if int8:
        tail_scales, det_scales = scales or (None, None)
        pipe = FusedPipeline(MODEL_CONFIG, use_int8_tail=True, int8_tail_start=TAIL_START,
                             warp_window=WINDOW, warp_fractional=True, use_int8_detector=True,
                             output_size=FACE, int8_act_scales=tail_scales,
                             det_act_scales=det_scales,
                             warp_tap_mode="int8" if path.startswith("E") else "legacy", **common)
    elif path.startswith(("B", "D", "F")):  # default warp arguments and face size
        extra = (dict(detector_arch="lite", keep_top_k=MULTI_K, warp_tap_mode="uw16")
                 if path.startswith("F") else {})
        pipe = FusedPipeline(MODEL_CONFIG, use_fused_backbone=path.startswith("D"), **extra,
                             **common)
        if (pipe.warp_window, pipe.warp_fractional, pipe.output_size) != (
                POOL_WINDOW, False, POOL_FACE):
            fail("FusedPipeline's defaults are not the pooled window-160 warp to 224² faces")
    else:
        pipe = FusedPipeline(MODEL_CONFIG, output_size=FACE, warp_window=WINDOW,
                             warp_fractional=True, warp_tap_mode="legacy",
                             use_fused_backbone=path.startswith("C"), **common)
    pipe.load_variables(seed=0)
    if int8 and scales is None:
        pipe.calibrate_int8(np.random.default_rng(1).uniform(0, 255, (8, *FACE, 3)), batch_size=8)
        pipe.calibrate_int8_detector(
            np.random.default_rng(2).uniform(0, 255, (4, *SERVING, 3)).astype(np.float32))
    return pipe


def seeded_batches(batch: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (batch, *SERVING, 3), dtype=np.uint8))
            for _ in range(n)]


def drawn_face_frames(n: int, size: int, seed: int, faces: int = 1) -> np.ndarray:
    """n uint8 RGB frames with ``faces`` upright drawn faces each on a colour
    gradient (skin ellipse, sclera and iris, brows, nose, mouth): the
    committed detectors find these with confidence near 1, so the chosen
    faces are clear on the card and on the CPU alike. Several faces get a
    vertical band of the frame each and sizes that differ by about 1.4×."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    frames = np.empty((n, size, size, 3), np.uint8)

    def ellipse(img, cx, cy, ax, ay, color):
        img[((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0] = color

    band = size / faces
    for i in range(n):
        base, gx, gy = rng.uniform(40, 200, 3), rng.normal(0, 0.1, 3), rng.normal(0, 0.1, 3)
        img = np.clip(base + gx * xs[..., None] + gy * ys[..., None], 0, 255).astype(np.float32)
        for k in range(faces):
            if faces == 1:  # the draws of the one-face frames the earlier paths check
                hw = rng.uniform(0.08, 0.22) * size
            else:
                hw = min(0.22 * size, band / 3.4) / 1.4 ** k * rng.uniform(0.9, 1.0)
            hh = hw * rng.uniform(1.15, 1.4)
            cx = rng.uniform(band * k + 1.6 * hw, band * (k + 1) - 1.6 * hw)
            cy = rng.uniform(1.2 * hh, size - 1.2 * hh)
            skin = np.asarray([230.0, 180.0, 150.0]) * rng.uniform(0.5, 1.0)
            ellipse(img, cx, cy, hw, hh, skin)
            ex, ey, er = 0.42 * hw, -0.28 * hh, max(2.0, 0.16 * hw)
            for side in (-1, 1):
                ellipse(img, cx + side * ex, cy + ey, er * 1.35, er * 0.85, (245, 245, 245))
                ellipse(img, cx + side * ex, cy + ey, er * 0.55, er * 0.55, rng.uniform(10, 120, 3))
                ellipse(img, cx + side * ex, cy + ey - 1.75 * er, er, max(1.0, 0.2 * er), (40, 30, 25))
            ellipse(img, cx, cy + 0.085 * hh, max(1.0, 0.035 * hw), 0.135 * hh, skin * 0.75)
            for side in (-1, 1):
                ellipse(img, cx + side * 0.1 * hw, cy + 0.26 * hh, max(1.0, 0.045 * hw),
                        max(1.0, 0.045 * hw), (60, 40, 35))
            ellipse(img, cx, cy + 0.55 * hh, 0.32 * hw, max(2.0, 0.11 * hw),
                    (rng.uniform(120, 200), rng.uniform(30, 80), rng.uniform(40, 90)))
        img += rng.normal(0, 4.0, img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def bound(nbytes: float, ops: float = 0.0, ops_per_s: float = INT8_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the tensor-core peak of their type (default: int8)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def one_launch(name: str, d: dict, kernel: str) -> None:
    """The wrapper call launched exactly one device kernel, its own."""
    if "source" in d:
        print(f"{name}: no device profile to count launches in ({d['source']})")
        return
    if d["launches"] != 1 or not all(kernel in k for k in d["kernels"]):
        fail(f"{name}: a call launched {d['launches']} device kernels, expected one "
             f"{kernel}: {sorted(d['kernels'])}")


def check_int8_gemm(ik, dev) -> list:
    """int8_gemm vs its plain version and torch._int_mm at the tail's shapes.
    The weights are K-major, as the tail runner keeps them; _int_mm is timed
    on the same tensors and on row-major weights, and the faster stands as
    the library call."""
    rows = []
    for M, K, N in GEMM_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(M + K + N)
        xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(dev)
        wq = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(dev)
        wk_major = wq.t().contiguous().t()
        sx = torch.tensor([0.0437], device=dev)
        sw = (torch.rand(N, generator=g) * 0.01 + 0.001).to(dev)
        b = torch.randn(N, generator=g).to(dev)
        got = ik.int8_gemm(xq, wk_major, sx, sw, b)
        torch.cuda.synchronize()
        err = (got - ik.int8_gemm_plain(xq, wq, sx, sw, b)).abs().max().item()
        t = time_ms(lambda: ik.int8_gemm(xq, wk_major, sx, sw, b))
        d = device_ms(lambda: ik.int8_gemm(xq, wk_major, sx, sw, b), "int8_gemm")
        one_launch("int8_gemm", d, "int8_gemm_mma_kernel")
        plain = time_ms(lambda: ik.int8_gemm_plain(xq, wq, sx, sw, b), iters=3, repeats=3)
        # The s32 product alone, no epilogue, on either weight layout.
        libs = {layout: (time_ms(lambda: torch._int_mm(xq, w)),
                         device_ms(lambda: torch._int_mm(xq, w)))
                for layout, w in (("row-major", wq), ("K-major", wk_major))}
        lib_layout = min(libs, key=lambda k: libs[k][1]["ms"])
        lib, lib_d = libs[lib_layout]
        # Context: the store floor, one PyTorch fill of an output this size.
        fill_out = torch.empty((M, N), device=dev)
        fill_d = device_ms(lambda: fill_out.zero_())
        plan = ik.int8_gemm_plan(M, K, N)
        b_ms, by = bound(M * K + K * N + 4 * M * N + 4 * (1 + 2 * N), 2.0 * M * K * N)
        print(f"int8_gemm ({M}, {K}) x ({K}, {N}), tile {plan.tile_m}x{plan.tile_n}, "
              f"{plan.blocks} blocks, {plan.copy_bytes}-byte copies: max_abs {err} "
              f"(tol {INT8_TOL}) kernel_ms {fmt(t)} device_ms {fmt_dev(d)} plain_ms {fmt(plain)} "
              + "; ".join(f"_int_mm ({k} weights) ms {fmt(v[0])} device_ms {fmt_dev(v[1])}"
                          for k, v in libs.items())
              + f"; bound_us {b_ms * 1e3:.2f} ({by}); context, the store floor: a fill "
              f"(zero_) of the f32 output, device_ms {fill_d['ms']:.4f}")
        if not err <= INT8_TOL:
            fail(f"int8_gemm disagrees with its plain version at {(M, K, N)}: {err}")
        rows.append({"shape": f"({M}, {K}) x ({K}, {N})", "max_abs_err": err, "ms": t["median"],
                     "ms_range": [t["min"], t["max"]], "device_ms": d["ms"],
                     "device_kernels": d["kernels"], "plan": plan._asdict(),
                     "plain_ms": plain["median"], "bound_ms": b_ms, "bound_by": by,
                     "library_ms": lib["median"], "library_device_ms": lib_d["ms"],
                     "library_layout": lib_layout,
                     "library_device_ms_by_layout": {k: v[1]["ms"] for k, v in libs.items()},
                     "context_fill_device_ms": fill_d["ms"]})
    return rows


def check_int8_conv(ik, dev, batch: int = 128) -> list:
    """int8_conv vs its plain version at the detector's shapes. No PyTorch
    call computes an s8 convolution on CUDA; the bf16 cuDNN convolution of
    the same shape is printed as context only: it is a different function."""
    import torch.nn.functional as F

    from deepfake_vit_tpu_torch.models.layers import same_pads

    rows = []
    for name, H, cin, cout, k, stride in CONV_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(H + cin + cout)
        xq = torch.randint(-127, 128, (batch, H, H, cin), generator=g, dtype=torch.int8).to(dev)
        kq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8).to(dev)
        sx = torch.tensor([0.031], device=dev)
        sw = (torch.rand(cout, generator=g) * 0.01 + 0.001).to(dev)
        b = torch.randn(cout, generator=g).to(dev)
        got = ik.int8_conv(xq, kq, sx, sw, b, stride)
        torch.cuda.synchronize()
        err = (got - ik.int8_conv_plain(xq, kq, sx, sw, b, stride)).abs().max().item()
        t = time_ms(lambda: ik.int8_conv(xq, kq, sx, sw, b, stride))
        d = device_ms(lambda: ik.int8_conv(xq, kq, sx, sw, b, stride), "int8_conv")
        plain = time_ms(lambda: ik.int8_conv_plain(xq, kq, sx, sw, b, stride), iters=2, repeats=3)
        lo, hi = same_pads(H, k, stride)
        x16 = F.pad(xq.permute(0, 3, 1, 2).to(torch.bfloat16), (lo, hi, lo, hi))
        k16 = kq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cudnn = time_ms(lambda: F.conv2d(x16, k16, None, stride))
        Ho = -(-H // stride)
        # Taps that fall on the image, per axis: padding taps do no work.
        taps = sum(sum(0 <= o * stride - lo + r < H for o in range(Ho)) for r in range(k))
        b_ms, by = bound(batch * H * H * cin + k * k * cin * cout + 4 * batch * Ho * Ho * cout
                         + 4 * (1 + 2 * cout), 2.0 * batch * taps * taps * cin * cout)
        print(f"int8_conv {name}, B = {batch}: max_abs {err} (tol {INT8_TOL}) kernel_ms {fmt(t)} "
              f"device_ms {fmt_dev(d)} plain_ms {fmt(plain)} bound_us {b_ms * 1e3:.2f} ({by}); "
              f"context, a different function: bf16 cuDNN convolution of this shape "
              f"{fmt(cudnn)} ms")
        if not err <= INT8_TOL:
            fail(f"int8_conv disagrees with its plain version at {name}: {err}")
        rows.append({"shape": f"{name}, B = {batch}", "max_abs_err": err, "ms": t["median"],
                     "ms_range": [t["min"], t["max"]], "device_ms": d["ms"],
                     "device_kernels": d["kernels"], "plain_ms": plain["median"],
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "context_bf16_cudnn_ms": cudnn["median"]})
    return rows


def check_crop_pool(wk, frames_flat, A_inv, dev) -> dict:
    """crop_pool vs its plain version: 128 faces, 640² frames, window 160."""
    from deepfake_vit_tpu_torch.ops.warp import max_window_levels, window_geometry

    N, H, WC = frames_flat.shape
    C, W = 3, WC // 3
    levels = max_window_levels((H, W), POOL_WINDOW)
    level, y0s, x0s, _ = window_geometry(A_inv, POOL_FACE, (H, W), POOL_WINDOW, levels, y_align=16)
    idx = torch.arange(N, device=dev)
    y0_l0 = y0s[level.long(), idx] << level
    x0 = x0s[level.long(), idx]
    hist = torch.bincount(level.long(), minlength=levels).tolist()
    print(f"pooled crop geometry: {N} faces, levels {hist}")
    if min(hist) == 0:
        fail("seeded geometry must cover every mip level")
    args = (frames_flat, y0_l0, x0, level, POOL_WINDOW, C)
    got = wk.crop_pool(*args)
    torch.cuda.synchronize()
    plain_args = (frames_flat, y0_l0.int(), x0.int(), level.int(), POOL_WINDOW, C, idx.int())
    err = (got.float() - wk.crop_pool_plain(*plain_args).float()).abs().max().item()
    t = time_ms(lambda: wk.crop_pool(*args))
    d = device_ms(lambda: wk.crop_pool(*args), "crop_pool")
    plain = time_ms(lambda: wk.crop_pool_plain(*plain_args), iters=3, repeats=3)
    side = torch.full_like(level.long(), POOL_WINDOW) << level.long()
    nbytes = int((side * side).sum().item()) * C * 2 + N * POOL_WINDOW ** 2 * C * 2 + N * 16
    b_ms, by = bound(nbytes)
    print(f"crop_pool: max_abs {err} (tol {POOL_TOL}) kernel_ms {fmt(t)} device_ms {fmt_dev(d)} "
          f"plain_ms {fmt(plain)} bound_us {b_ms * 1e3:.2f} ({nbytes} bytes); no single PyTorch "
          f"call computes it")
    if not err <= POOL_TOL:
        fail(f"crop_pool disagrees with its plain version: {err}")
    return {"shape": f"{N} faces, {H}² frames, window {POOL_WINDOW}, levels {hist}",
            "max_abs_err": err, "ms": t["median"], "ms_range": [t["min"], t["max"]],
            "device_ms": d["ms"], "device_kernels": d["kernels"],
            "plain_ms": plain["median"], "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def fused_agreement(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Hold a fused kernel's output to its plain version's: within two bf16
    steps of the value everywhere; returns the largest difference and the
    share of elements that differ at all."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: bad output {tuple(got.shape)} against {tuple(want.shape)}")
    diff = (got - want).abs()
    over = int((diff > FUSED_TOL * want.abs().clamp_min(1.0)).sum().item())
    res = {"max_abs_err": diff.max().item(), "share_differing": (diff > 0).float().mean().item()}
    if over:
        fail(f"{name} disagrees with its plain version: {over} of {want.numel()} elements "
             f"beyond two bf16 steps, largest difference {res['max_abs_err']}")
    return res


def valid_taps(size: int, out: int, k: int, stride: int, before: int) -> int:
    """Taps of one axis that fall on the image, summed over the outputs."""
    return sum(sum(0 <= o * stride - before + r < size for o in range(out)) for r in range(k))


def block_bound(bp, B: int, h: int, weights):
    """(bound_ms, bound_by) of one MBConv block: input, output and weights
    once against the memory rate; the multiply-adds of expand, depthwise
    (taps on the image only), squeeze-excite and projection, times two,
    against the bf16 tensor-core peak."""
    ho = h // bp.stride
    before = bp.kernel // 2 if bp.stride == 1 else (bp.kernel - 2) // 2
    taps = valid_taps(h, ho, bp.kernel, bp.stride, before)
    macs = B * ((h * h * bp.cin * bp.cexp if bp.has_expand else 0) + taps * taps * bp.cexp
                + 2 * bp.cexp * bp.cse + ho * ho * bp.cexp * bp.cout)
    nbytes = (2 * B * (h * h * bp.cin + ho * ho * bp.cout)
              + sum(w.numel() * w.element_size() for w in weights))
    return bound(nbytes, 2.0 * macs, BF16_OPS_PER_S)


def fused_row(name, shape, agree, t, d, plain, b_ms, by, context) -> dict:
    print(f"{name} {shape}: max_abs {agree['max_abs_err']:.6f} (limit two bf16 steps), "
          f"{agree['share_differing']:.2e} of the elements differ; kernel_ms {fmt(t)} device_ms "
          f"{fmt_dev(d)} plain_ms {fmt(plain)} bound_us {b_ms * 1e3:.2f} ({by}); no single "
          f"PyTorch call computes it; context, a different function (BatchNorm not folded): the "
          f"port's eager module on this input {fmt(context)} ms")
    return {"shape": shape, **agree, "ms": t["median"], "ms_range": [t["min"], t["max"]],
            "device_ms": d["ms"], "device_kernels": d["kernels"],
            "plain_ms": plain["median"], "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "context_eager_module_ms": context["median"]}


def check_fused(fs, fm, dev):
    """run_stem, run_block and fused_mbconv against their plain versions at
    B4's shapes, on seeded weights and inputs. Returns (stem row, block
    rows, prototype rows)."""
    import torch.nn.functional as F

    from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.ops.image import normalize_imagenet

    bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(3)

    B = 128
    faces = torch.randint(0, 256, (B, *FACE, 3), generator=g, dtype=torch.uint8).to(dev)
    x = normalize_imagenet(faces.float() / 255.0).to(torch.bfloat16)
    sw = fs.fold_stem_weights(bb)
    got = fs.run_stem(x, sw)
    torch.cuda.synchronize()
    agree = fused_agreement("run_stem", got, fs.run_stem_plain(x, sw))
    t = time_ms(lambda: fs.run_stem(x, sw))
    d = device_ms(lambda: fs.run_stem(x, sw), "fused_stem")
    plain = time_ms(lambda: fs.run_stem_plain(x, sw), iters=3, repeats=3)
    x_nchw = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
        eager = time_ms(lambda: F.silu(bb.stem_bn(bb.stem_conv(x_nchw))), iters=5, repeats=3)
    ho = FACE[0] // 2
    taps = valid_taps(FACE[0], ho, 3, 2, 0)
    c0 = sw[0].shape[0]
    b_ms, by = bound(x.numel() * 2 + B * ho * ho * c0 * 2 + sw[0].numel() * 2 + c0 * 4,
                     2.0 * B * taps * taps * 3 * c0, BF16_OPS_PER_S)
    stem_row = fused_row("run_stem", f"({B}, {FACE[0]}, {FACE[1]}, 3) -> {c0} channels", agree, t,
                         d, plain, b_ms, by, eager)
    del x, x_nchw, faces, got

    def block_case(label, idx, h, B):
        blk = getattr(bb, f"block_{idx}")
        bp = fs.block_plan_from_args(bb.blocks[idx])
        weights = fs.fold_block_weights(blk, bp)
        x = torch.randn((B, h, h, bp.cin), generator=g).to(dev).to(torch.bfloat16)
        if label == "run_block":
            run, run_plain = (lambda: fs.run_block(bp, x, weights),
                              lambda: fs.run_block_plain(bp, x, weights))
        else:
            ratio = bb.blocks[idx]["expand_ratio"]
            folded = fm.fold_mbconv_params(blk, ratio)
            run, run_plain = (lambda: fm.fused_mbconv(x, folded, ratio),
                              lambda: fm.fused_mbconv_plain(x, folded, ratio))
        got = run()
        torch.cuda.synchronize()
        agree = fused_agreement(label, got, run_plain())
        t = time_ms(run)
        d = device_ms(run, "fused_", iters=5)
        plain = time_ms(run_plain, iters=2, repeats=3)
        x_nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            eager = time_ms(lambda: blk(x_nchw), iters=5, repeats=3)
        b_ms, by = block_bound(bp, B, h, weights)
        shape = (f"B4 block {idx}, B = {B}, {h}² -> {h // bp.stride}², k{bp.kernel} "
                 f"{bp.cin} -> {bp.cexp} -> {bp.cout}")
        return fused_row(label, shape, agree, t, d, plain, b_ms, by, eager)

    block_rows = [block_case("run_block", *case) for case in FUSED_BLOCKS]
    proto_rows = [block_case("fused_mbconv", *case) for case in PROTO_BLOCKS]
    return stem_row, block_rows, proto_rows


def warp_grid(coeffs: torch.Tensor, out_size, src: int) -> torch.Tensor:
    """The normalized sampling grid of ``F.grid_sample`` for the warp with
    dst→src rows ``coeffs`` (N, 6) from a src×src image (align_corners=False)."""
    ii = torch.arange(out_size[0], dtype=torch.float32, device=coeffs.device)[:, None]
    jj = torch.arange(out_size[1], dtype=torch.float32, device=coeffs.device)[None, :]
    a, b, c, d, e, f = (coeffs[:, k, None, None] for k in range(6))
    return torch.stack([(2 * (a * jj + b * ii + c) + 1) / src - 1,
                        (2 * (d * jj + e * ii + f) + 1) / src - 1], -1)


def check_warp(name: str, fn, plain_fn, crop, A_win, out_size) -> dict:
    """A warp kernel vs its plain version on the crops ``crop`` (N, S, S, C)
    with dst→window affines ``A_win``, timed next to ``F.grid_sample`` on
    the same input and grid and to its bytes bound (the crop pixels its
    taps touch read once, the float32 output written once; the rank-1 and
    int8 taps have the legacy support, so the footprint is the legacy one)."""
    import torch.nn.functional as F

    N, S, _, C = crop.shape
    coeffs = A_win.reshape(N, 6).float().contiguous()
    got = fn(crop, A_win, out_size, inverse=True)
    torch.cuda.synchronize()
    err = (got - plain_fn(crop, coeffs, out_size)).abs().max().item()
    t = time_ms(lambda: fn(crop, A_win, out_size, inverse=True))
    d = device_ms(lambda: fn(crop, A_win, out_size, inverse=True), "warp_")
    plain = time_ms(lambda: plain_fn(crop, coeffs, out_size), iters=5, repeats=5)
    grid, crop_nchw = warp_grid(coeffs, out_size, S), crop.permute(0, 3, 1, 2).float().contiguous()

    def lib_call():
        return F.grid_sample(crop_nchw, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    lib, lib_d = time_ms(lib_call), device_ms(lib_call)
    nbytes = (warp_footprint_bytes(coeffs, S, S, C, out_size)
              + N * out_size[0] * out_size[1] * C * 4 + N * 6 * 4)
    print(f"{name} ({N}, {S}², {C}) -> {out_size[0]}²: max_abs {err} (tol {WARP_TOL}) kernel_ms "
          f"{fmt(t)} device_ms {fmt_dev(d)} plain_ms {fmt(plain)} grid_sample_ms {fmt(lib)} "
          f"device_ms {fmt_dev(lib_d)} bound_us {nbytes / HBM_BYTES_PER_S * 1e6:.2f} "
          f"({nbytes} bytes)")
    if not err <= WARP_TOL:
        fail(f"{name} disagrees with its plain version: {err}")
    return {"out": got, "max_abs_err": err, "ms": t["median"], "ms_range": [t["min"], t["max"]],
            "device_ms": d["ms"], "device_kernels": d["kernels"],
            "plain_ms": plain["median"], "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": lib["median"], "library_device_ms": lib_d["ms"],
            "shape": f"{N} faces, {S}² crops -> {out_size[0]}²"}


def check_crop(name: str, fn, plain_fn, args, plain_args, lib_call, nbytes: int):
    """A fractional crop kernel vs its plain version, timed next to
    ``F.grid_sample`` computing the same bilinear resample (``lib_call``)
    and to its bytes bound. Returns the kernel's output and the row."""
    got = fn(*args)
    torch.cuda.synchronize()
    err = (got.float() - plain_fn(*plain_args).float()).abs().max().item()
    t = time_ms(lambda: fn(*args))
    d = device_ms(lambda: fn(*args), "crop_frac")
    one_launch(name, d, "crop_frac_band_kernel")
    plain = time_ms(lambda: plain_fn(*plain_args), iters=5, repeats=5)
    lib, lib_d = time_ms(lib_call), device_ms(lib_call)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{name}: max_abs {err} (tol {CROP_TOL}) kernel_ms {fmt(t)} device_ms {fmt_dev(d)} "
          f"plain_ms {fmt(plain)} grid_sample_ms {fmt(lib)} device_ms {fmt_dev(lib_d)} "
          f"bound_us {b_ms * 1e3:.2f} ({nbytes} bytes; the rank-1 taps have the legacy support)")
    if not err <= CROP_TOL:
        fail(f"{name} disagrees with its plain version: {err}")
    return got, {"max_abs_err": err, "ms": t["median"], "ms_range": [t["min"], t["max"]],
                 "device_ms": d["ms"], "device_kernels": d["kernels"], "plain_ms": plain["median"],
                 "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib["median"],
                 "library_device_ms": lib_d["ms"]}


def check_rank1_warps(wk, frames_flat, dev):
    """warp_affine_uw and warp_affine_uw16 at path F's shapes: 32 frames x 3
    faces, pooled window-160 crops to 224² faces. They are one function:
    their outputs must be equal bit for bit."""
    from deepfake_vit_tpu_torch.ops.warp import max_window_levels, window_geometry

    N = BATCH * MULTI_K
    H, W = frames_flat.shape[1], frames_flat.shape[2] // 3
    A_inv = seeded_geometry(N, 7, dev)
    level, y0s, x0s, A_win = window_geometry(A_inv, POOL_FACE, (H, W), POOL_WINDOW,
                                             max_window_levels((H, W), POOL_WINDOW), y_align=16)
    idx = torch.arange(N, device=dev)
    crop = wk.crop_pool(frames_flat[:BATCH], y0s[level.long(), idx] << level,
                        x0s[level.long(), idx], level, POOL_WINDOW, 3,
                        frame_idx=idx // MULTI_K).reshape(N, POOL_WINDOW, POOL_WINDOW, 3)
    rows = {name: check_warp(name, getattr(wk, name), wk.warp_affine_uw_plain, crop, A_win,
                             POOL_FACE) for name in ("warp_affine_uw", "warp_affine_uw16")}
    if not torch.equal(rows["warp_affine_uw"].pop("out"), rows["warp_affine_uw16"].pop("out")):
        fail("warp_affine_uw and warp_affine_uw16 differ on the card: they are one function")
    print("warp_affine_uw == warp_affine_uw16 bit for bit on the card")
    return rows


def drive_uw(kernels, batch_u8: torch.Tensor, dev) -> dict:
    """The "uw" tap mode is on no served path: drive it through its entry
    point, ``warp_affine_windowed(tap_construction="uw")``, on a served
    batch with 3 faces a frame, counting launches, and hold it to the same
    call with "uw16". Returns the launch counts of the "uw" call."""
    from deepfake_vit_tpu_torch.ops.warp import warp_affine_windowed

    N = BATCH * MULTI_K
    frames = batch_u8[:BATCH].to(dev)
    A_inv = seeded_geometry(N, 9, dev)
    args = dict(window=POOL_WINDOW, inverse=True,
                frame_indices=torch.arange(N, device=dev) // MULTI_K)
    for k in kernels:
        k.launches = 0
    uw = warp_affine_windowed(frames, A_inv, POOL_FACE, tap_construction="uw", **args)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    want = {**dict.fromkeys(KERNEL_NAMES, 0), "crop_pool": 1, "warp_affine_uw": 1}
    if launches != want:
        fail(f"warp_affine_windowed(tap_construction='uw'): launches {launches}, expected {want}")
    uw16 = warp_affine_windowed(frames, A_inv, POOL_FACE, tap_construction="uw16", **args)
    if not torch.equal(uw, uw16):
        fail("the 'uw' and 'uw16' windowed warps differ on the card")
    print(f"warp_affine_uw driven through warp_affine_windowed on {N} faces of {BATCH} served "
          f"frames: launches {launches}; equal to the uw16 call bit for bit")
    return launches


def drive_prototype(fm, model, dev) -> int:
    """The single-block prototype is on no pipeline's path: drive it through
    its public entry on blocks 3 (48²) and 12 (14²) of the served model and
    hold it to the unfused module in float32. Returns its launch count."""
    fm.fused_mbconv.launches = 0
    backbone = model.feature_extractor.backbone
    g = torch.Generator(device="cpu").manual_seed(11)
    for idx, h, _ in PROTO_BLOCKS:
        blk = getattr(backbone, f"block_{idx}")
        args = backbone.blocks[idx]
        x = torch.randn((BATCH, h, h, args["in_filters"]), generator=g).to(dev)
        out = fm.fused_mbconv(x, fm.fold_mbconv_params(blk, args["expand_ratio"]),
                              args["expand_ratio"])
        torch.cuda.synchronize()
        with torch.inference_mode():
            ref = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        err = (out.float() - ref).abs()
        print(f"fused_mbconv driven on B4 block {idx} at {h}², B = {BATCH}: max_abs "
              f"{err.max().item():.5f} against the unfused float32 module (atol 0.03, rtol 0.05)")
        if out.shape != ref.shape or not bool((err <= 0.03 + 0.05 * ref.abs()).all()):
            fail(f"fused_mbconv disagrees with the unfused module on block {idx}")
    return fm.fused_mbconv.launches


def card_vs_cpu(path: str, frames: np.ndarray, limits: dict) -> dict:
    """The pipeline on the card against the same pipeline on the CPU (plain
    kernel versions), float32 without TF32; path A hands the card's
    calibrated scales to the CPU side."""
    outs, scales = {}, None
    with tf32_off():
        for where in ("cuda", "cpu"):
            p = build_pipeline(path, torch.float32, where, scales)
            if path.startswith(("A", "E")):
                scales = (p.int8_act_scales, p.det_act_scales)
            outs[where] = {k: v.float().cpu().numpy() for k, v in p.forward(frames).items()}
            del p
    if outs["cuda"]["confidence"].min() < 0.5:
        fail(f"path {path}: the drawn faces were not detected: {outs['cuda']['confidence']}")
    err = {k: float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max()) for k in limits
           if k != "features_rel"}
    if "features_rel" in limits:  # relative to the largest feature: seeded weights give tiny ones
        feats = outs["cpu"]["features"]
        err["features_rel"] = float(np.abs(outs["cuda"]["features"] - feats).max()
                                    / np.abs(feats).max())
    print(f"path {path}: card vs CPU, float32, {len(frames)} frames with drawn faces "
          f"(confidence {outs['cuda']['confidence'].min():.3f}+): max_abs {err} (limits {limits})")
    if not all(err[k] <= limits[k] for k in limits):
        fail(f"path {path}: the pipeline on the card disagrees with the CPU: {err} > {limits}")
    return err


def warm_up(pipe, frames) -> None:
    """One batch outside any count or timing: cuDNN algorithm choice, allocator."""
    pipe.forward(frames)
    torch.cuda.synchronize()


def serve(pipe, batches):
    """Serve the batches; returns the outputs and the host-clock seconds."""
    t0 = time.perf_counter()
    results = [pipe.forward(fr) for fr in batches]
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def classify_kernel(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise / other"


def profile_batch(pipe, frames, batch_ms: float) -> dict:
    """One served batch under torch.profiler: device time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.forward(frames)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key] += ev.self_device_time_total
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time")
    by_class = defaultdict(float)
    for name, us in by_kernel.items():
        by_class[classify_kernel(name)] += us
    return {
        "profiled_wall_us": wall_us, "device_busy_us": busy_us,
        # Against the unprofiled batch time: the profiler slows the host.
        "device_idle_share": max(0.0, 1.0 - busy_us / (batch_ms * 1e3)),
        "device_us_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_us": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12],
    }


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")

    import torch.nn.functional as F

    from deepfake_vit_tpu_torch.ops import fused_mbconv as fm
    from deepfake_vit_tpu_torch.ops import fused_stages as fs
    from deepfake_vit_tpu_torch.ops import int8_kernel as ik
    from deepfake_vit_tpu_torch.ops import warp_kernel as wk
    from deepfake_vit_tpu_torch.ops.warp import frac_window_levels, window_geometry_frac

    # 1. The card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 2. Build.
    t0 = time.time()
    lib = wk.build_library(verbose=True)
    print(f"build: {time.time() - t0:.1f} s -> {lib.name}")

    # 3. Kernels vs plain versions at the serving shapes.
    H, W = SERVING
    C = 3
    N = 128
    g = torch.Generator(device="cpu").manual_seed(0)
    frames = torch.randint(0, 256, (N, H, W, C), generator=g, dtype=torch.uint8).to(dev)
    frames_flat = frames.to(torch.bfloat16).reshape(N, H, W * C)
    A_inv = seeded_geometry(N, 1, dev)
    levels = frac_window_levels(H, WINDOW)
    level, strip0s, r, off_y, x0f, A_win = window_geometry_frac(
        A_inv, FACE, (H, W), WINDOW, levels, y_align=16)
    strip0 = strip0s[level.long(), torch.arange(N, device=dev)]
    hist = torch.bincount(level.long(), minlength=levels).tolist()
    n_r1 = int((r == 1.0).sum().item())
    print(f"crop geometry: {N} faces, strip buckets {hist}, r == 1 for {n_r1}")
    if min(hist) == 0 or n_r1 == 0:
        fail("seeded geometry must cover every strip bucket and r == 1")

    crop_args = (frames_flat, strip0, level, r, off_y, x0f, WINDOW, C)
    plain_args = (frames_flat, strip0.int(), level.int(), torch.round(r * 65536).int(),
                  off_y.int(), x0f.int(), WINDOW, C, torch.arange(N, device=dev).int())
    # The geometry's own types go to the wrappers (float32 r, off_y, x0f;
    # frame_idx None); the plain version takes the int32 forms.
    crop_args = (frames_flat, strip0, level, r, off_y, x0f, WINDOW, C)
    plain_args = (frames_flat, strip0.int(), level.int(), torch.round(r * 65536).int(),
                  off_y.int(), x0f.int(), WINDOW, C, torch.arange(N, device=dev).int())
    # Yardstick: one grid_sample computing the same bilinear resample.
    i = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    gy = (strip0.float() + off_y)[:, None] + (i + 0.5) * r[:, None] - 0.5
    gx = x0f[:, None] + (i + 0.5) * r[:, None] - 0.5
    grid = torch.stack(torch.broadcast_tensors(
        ((2 * gx + 1) / W - 1)[:, None, :], ((2 * gy + 1) / H - 1)[:, :, None]), -1)
    frames_nchw = frames.permute(0, 3, 1, 2).float().contiguous()

    def crop_lib():
        return F.grid_sample(frames_nchw, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    crop_bytes = (crop_footprint_bytes(strip0, level, r, off_y, x0f, H, W, C)
                  + N * WINDOW * WINDOW * C * 2 + N * 6 * 4)
    crop_k, crop_row = check_crop("crop_frac", wk.crop_frac, wk.crop_frac_plain, crop_args,
                                  plain_args, crop_lib, crop_bytes)
    legacy_row = check_warp("warp_affine_legacy", wk.warp_affine_legacy,
                            wk.warp_affine_legacy_plain, crop_k.reshape(N, WINDOW, WINDOW, C),
                            A_win, FACE)
    legacy_row.pop("out")

    # The rank-1 ("mxu") crop and the int8 warp at path E's shapes, the
    # rank-1 warps at path F's.
    mxu_k, mxu_row = check_crop(
        "crop_frac_mxu", wk.crop_frac_mxu,
        lambda *a: wk.crop_frac_plain(*a, construction="mxu"), crop_args, plain_args, crop_lib,
        crop_bytes)
    r1 = r == 1.0
    if not torch.equal(mxu_k[r1], crop_k[r1]):
        fail("crop_frac_mxu is not an exact copy at r = 1")
    del frames_nchw
    int8_row = check_warp("warp_affine_int8", wk.warp_affine_int8, wk.warp_affine_int8_plain,
                          mxu_k.reshape(N, WINDOW, WINDOW, C), A_win, FACE)
    int8_row.pop("out")
    del mxu_k, crop_k
    rank1_rows = check_rank1_warps(wk, frames_flat, dev)
    pool_row = check_crop_pool(wk, frames_flat, A_inv, dev)
    del frames, frames_flat
    gemm_rows = check_int8_gemm(ik, dev)
    conv_rows = check_int8_conv(ik, dev)
    stem_row, block_rows, proto_rows = check_fused(fs, fm, dev)
    torch.cuda.empty_cache()

    # 4. Each pipeline on the card vs on the CPU (plain kernel versions),
    #    float32. Float convolutions differ in the last place between cuDNN
    #    and the CPU; on the int8 path that now and then puts an activation
    #    on the other side of a rounding tie and moves it one quantization
    #    step, hence the wider limits of path A. The fused backbone works
    #    in bf16 whatever the pipeline dtype, and kernel and plain version
    #    differ by a bf16 step in a small share of the early activations,
    #    which the float32 tail carries on. The seeded B4 puts every
    #    probability at 0.5 (its features are of the order 1e-7), so the
    #    fused paths are also held on the features, relative to the largest.
    faces = drawn_face_frames(2, SERVING[0], 5)
    tight = {"bbox": 1e-2, "landmarks": 1e-2, "quality": 1e-2, "probs": 1e-3}
    fused = {**tight, "features_rel": FUSED_FEATURES_REL}
    int8_limits = {"confidence": 0.02, "bbox": 0.5, "landmarks": 0.5, "quality": 0.02,
                   "probs": 0.02}
    card_vs_cpu_err = {
        "bf16 headline geometry": card_vs_cpu("bf16 headline geometry", faces, tight),
        "B default pooled warp": card_vs_cpu("B default pooled warp", faces, tight),
        "A int8 headline": card_vs_cpu("A int8 headline", faces, int8_limits),
        "C fused backbone": card_vs_cpu("C fused backbone", faces, fused),
        "D fused backbone, default geometry": card_vs_cpu(
            "D fused backbone, default geometry", faces, fused),
        "E int8-tap headline": card_vs_cpu("E int8-tap headline", faces, int8_limits),
        # Three faces of different sizes a frame: the NMS order is no near tie.
        "F multi-face, lite detector": card_vs_cpu(
            "F multi-face, lite detector", drawn_face_frames(2, SERVING[0], 6, faces=3),
            {**tight, "confidence": 1e-3, "face_valid": 0.0}),
    }

    # 5 + 6. The five paths, served in turns (A, B, bf16, C, D, then back:
    #    end-to-end numbers compare only within one call, and the second
    #    round shows what the order does) and profiled once each. The same
    #    seeded batches feed all of them.
    served = {bsz: seeded_batches(bsz, N_BATCHES, bsz) for bsz in PROFILE_BATCHES}
    kernels = (wk.crop_frac, wk.crop_frac_mxu, wk.crop_pool, wk.warp_affine_legacy,
               wk.warp_affine_uw, wk.warp_affine_uw16, wk.warp_affine_int8, ik.int8_gemm,
               ik.int8_conv, fs.run_stem, fs.run_block, fm.fused_mbconv)
    if tuple(k.__name__ for k in kernels) != KERNEL_NAMES:
        fail("the counted kernels are not KERNEL_NAMES")
    pipes = {path: build_pipeline(path) for path in EXPECTED}
    paths = {path: {"launches_per_batch": expected, "rounds": [], "profile": []}
             for path, expected in EXPECTED.items()}
    for rnd, order in enumerate((list(EXPECTED), list(EXPECTED)[::-1])):
        for path in order:
            pipe, expected = pipes[path], EXPECTED[path]
            face, feat = pipe.output_size, pipe.model.feature_extractor.feature_dim
            K = pipe.keep_top_k
            for bsz in PATH_BATCHES[path]:
                warm_up(pipe, served[bsz][0])
                for k in kernels:
                    k.launches = 0
                results, secs = serve(pipe, served[bsz])
                launches = {k.__name__: k.launches for k in kernels}
                batch_ms = secs * 1e3 / N_BATCHES
                # Faces: every frame's K face slots are aligned and classified.
                res = {"round": rnd, "batch": bsz, "faces_per_s": bsz * K * N_BATCHES / secs,
                       "frames_per_s": bsz * N_BATCHES / secs, "ms_per_batch": batch_ms}
                paths[path]["rounds"].append(res)
                print(f"[{card}] round {rnd}, path {path} ({face[0]}² faces, {K} a frame), batch "
                      f"{bsz}: served {N_BATCHES} x {bsz} frames in {secs:.3f} s: "
                      f"{res['faces_per_s']:.1f} faces/s, {res['frames_per_s']:.1f} frames/s, "
                      f"{batch_ms:.2f} ms/batch; launches {launches}")
                for out in results:
                    lead = (bsz, K) if K > 1 else (bsz,)
                    if out["probs"].shape != (*lead, 2) or out["features"].shape != (*lead, feat):
                        fail(f"bad output shapes {out['probs'].shape}, {out['features'].shape}")
                    for key in ("probs", "bbox", "landmarks", "quality", "features", "fake_prob"):
                        if not torch.isfinite(out[key].float()).all():
                            fail(f"non-finite {key} on path {path}")
                want = {k: n * N_BATCHES for k, n in expected.items()}
                if launches != want:
                    fail(f"path {path}: launches {launches}, expected {want}")
                if rnd == 0 and bsz == BATCH:
                    paths[path]["launches"] = launches
                del results
                if rnd:
                    continue
                prof = {**res, **profile_batch(pipe, served[bsz][0], batch_ms)}
                paths[path]["profile"].append(prof)
                print(f"    profiled batch: device busy {prof['device_busy_us'] / 1e3:.3f} ms, "
                      f"idle share {prof['device_idle_share']:.3f}")
                for label, us in prof["device_us_by_class"].items():
                    print(f"    {label:34s} {us / 1e3:8.3f} ms")
                for name, us in prof["top_kernels_us"][:6]:
                    print(f"    {us / 1e3:8.3f} ms  {name[:100]}")
    proto_launches = drive_prototype(fm, pipes["C fused backbone"].model, dev)
    if proto_launches != len(PROTO_BLOCKS):
        fail(f"fused_mbconv counted {proto_launches} launches for {len(PROTO_BLOCKS)} calls")
    uw_launches = drive_uw(kernels, served[BATCH][0], dev)
    del pipes

    # The kernels' line: launches from the headline path (path A), crop_pool's
    # from path B, the first path that runs it, the fused stem's and block's
    # from path C (one launch of run_block is a group of three device
    # launches), the rank-1 crop's and the int8 warp's from path E, the uw16
    # warp's from path F, the prototype's and the uw warp's from their own
    # drives. The rows with several shapes carry their first; "shapes" holds
    # every measured shape.
    a_launches, b_launches, c_launches, e_launches, f_launches = (paths[k]["launches"] for k in (
        "A int8 headline", "B default pooled warp", "C fused backbone", "E int8-tap headline",
        "F multi-face, lite detector"))
    print(f"fused backbone: {fs.LAUNCHES_PER_BLOCK} device launches per block launch group; "
          f"path C makes 1 + {EXPECTED['C fused backbone']['run_block']} groups = "
          f"{1 + fs.LAUNCHES_PER_BLOCK * EXPECTED['C fused backbone']['run_block']} device "
          f"launches per batch, path D 1 + "
          f"{EXPECTED['D fused backbone, default geometry']['run_block']} groups = "
          f"{1 + fs.LAUNCHES_PER_BLOCK * EXPECTED['D fused backbone, default geometry']['run_block']}")

    def row(name, source, replaces, launches, m, shapes=None, construction=None):
        out = {"name": name, "route": "cuda", "source": f"deepfake_vit_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches,
               **{k: m[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms")},
               "library_device_ms": m.get("library_device_ms")}
        if construction is not None:  # the TPU kernel's construction this one replaces
            out["construction"] = construction
        if shapes is not None:
            out["max_abs_err"] = max(r["max_abs_err"] for r in shapes)
            out["shape"], out["shapes"] = m["shape"], shapes
        return out

    report = {"kernels": [
        row("crop_frac", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:564",
            a_launches["crop_frac"], crop_row, construction="legacy"),
        row("crop_frac_mxu", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:564",
            e_launches["crop_frac_mxu"], mxu_row, construction="mxu"),
        row("warp_affine_legacy", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            a_launches["warp_affine_legacy"], legacy_row, construction="legacy"),
        row("warp_affine_uw", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            uw_launches["warp_affine_uw"], rank1_rows["warp_affine_uw"], construction="uw"),
        row("warp_affine_uw16", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            f_launches["warp_affine_uw16"], rank1_rows["warp_affine_uw16"], construction="uw16"),
        row("warp_affine_int8", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            e_launches["warp_affine_int8"], int8_row, construction="int8"),
        row("crop_pool", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:356",
            b_launches["crop_pool"], pool_row),
        row("int8_gemm", "int8.cu", "deepfake_vit_tpu/models/int8_tail.py:42",
            a_launches["int8_gemm"], gemm_rows[0], gemm_rows),
        row("int8_conv", "int8.cu", "deepfake_vit_tpu/models/scrfd_int8.py:160",
            a_launches["int8_conv"], conv_rows[0], conv_rows),
        row("run_stem", "fused.cu", "deepfake_vit_tpu/ops/pallas/fused_stages.py:372",
            c_launches["run_stem"], stem_row, [stem_row]),
        row("run_block", "fused.cu", "deepfake_vit_tpu/ops/pallas/fused_stages.py:216",
            c_launches["run_block"], block_rows[0], block_rows),
        row("fused_mbconv", "fused.cu", "deepfake_vit_tpu/ops/pallas/fused_mbconv.py:60",
            proto_launches, proto_rows[0], proto_rows),
    ]}
    if any(k["launches"] < 1 for k in report["kernels"]):
        fail(f"a kernel was never launched: {[(k['name'], k['launches']) for k in report['kernels']]}")
    headline = paths["A int8 headline"]["profile"][0]
    extra = {"card": card, "kind": kind, "faces_per_s": headline["faces_per_s"],
             "kernel_faces": N, "crop_buckets": hist, "r_eq_1_faces": n_r1,
             "crop_rows": {"crop_frac": crop_row, "crop_frac_mxu": mxu_row},
             "warp_rows": {"warp_affine_legacy": legacy_row, "warp_affine_int8": int8_row,
                           **rank1_rows},
             "bound_bytes": {"crop_frac": crop_bytes},
             "crop_pool": pool_row, "card_vs_cpu": card_vs_cpu_err, "paths": paths,
             "device_launches_per_fused_block": fs.LAUNCHES_PER_BLOCK,
             "torch": torch.__version__, "cuda": torch.version.cuda}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({**report, **extra}, indent=1))
    timings = [k["ms"] for k in report["kernels"]] + [
        r["faces_per_s"] for v in paths.values() for r in v["rounds"]]
    if not all(math.isfinite(v) for v in timings):
        fail("a timing is not finite")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
