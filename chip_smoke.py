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
   library call and its bound. The crop, warp, int8 and stem wrappers
   must launch exactly one device kernel a call. The GEMM gets K-major weights,
   as the int8 tail keeps them; ``torch._int_mm`` is timed on those and on
   row-major weights and the faster stands as the library call; a fill of
   the f32 output is printed as the store floor. The convolution runs at
   every distinct shape that path A's detector launches in one served batch
   (recorded from its runner, 25 launches, 12 shapes), its kernels K-major
   as the runner keeps them, and the per-batch sums of device time and
   bound are printed. The stem runs at paths C's and D's shapes, beside one
   cuDNN convolution of the same product as context (no SiLU: not the same
   function); the pooled crop at paths B's and F's (faces sharing frames). The two int8 kernels and the four warps (legacy,
   "uw", "uw16" and int8 taps) must agree bit for bit, the three crops (the
   fractional crop with legacy and rank-1 "mxu" taps, the pooled crop)
   within one bf16 step (they agree bit for bit), "uw" and "uw16" with each
   other bit for bit, the fused stem, MBConv block (B4's blocks, and b6's
   and b7's widest, whose cout of 200 and 224 runs in two projection
   groups) and single-block prototype within two bf16 steps of the value
   (their 1×1 products sum in another order than the plain versions', on
   the tensor cores); the share of elements that differ at all is printed
   beside the largest difference. A warp geometry phase runs every warp construction on rolls of
   0°, 30°, 90° and 180°, a mirror, sources wholly and partly outside and a
   whole-frame down-scale, bit for bit, and prints which tiles staged their
   source box and which read from device memory (both must run). Prints,
   as context, path G's s2d stages' device time beside the stock blocks
   they replace (a seeded B4).
4. The inference entry point: ``DeepfakePredictor.from_packaged`` (the
   committed b0 classifier and SCRFD) on a 5-frame 1280×720 clip
   (letterboxed into the 640² canvas) and a 32-frame 640² clip of drawn
   faces, held to the same predictor on the CPU in float32, then timed in
   bf16 on the card (ms a clip, host clock) with one warp launch a clip,
   and a B4 predictor at full width (seeded) on the 640² clip; the
   whole-frame warp at the clips' shapes and on two 1920×1080 frames, bit
   for bit against its plain version, with the tiles that read from device
   memory counted (at least one must), timed beside ``F.grid_sample`` and
   its bound; ``PreprocessingPipeline(PREPROCESSING_CONFIG)``'s one-graph
   batch of 32 frames on the card against the CPU.
   Then the training path: the warp kernel at the train step's shape (32
   ImageNet-normalized 224² faces rotated by up to 5°, bit for bit, timed
   beside ``F.grid_sample`` and its bound); one AdamW step of the B4 at
   224², batch 4, on the card in float32 without TF32 against a float64
   step on the CPU, on each of the five batches of ``TRAIN_SEEDS`` (within
   ``TRAIN_LIMITS``), the CPU's float32 step printed beside it; the bf16
   step (against the CPU's float32 one) piece by piece within
   ``BF16_PIECE_LIMITS``, which two coarser controls must break, and the
   whole bf16 step printed beside it); the optimizer alone, card against
   CPU, with weight decay visible; 30 steps of the
   training configuration with augmentation on one batch of 32 drawn
   faces through ``Trainer``'s step, one warp launch a step and no other
   kernel, the loss falling; the checkpoint into ``DeepfakePredictor``
   (its probabilities equal the trainer's eval step's within 1e-3, and it
   serves frames); ms a step, images/s and peak memory of the full
   configuration at B = 32 and 64, twice in turns; one profiled step
   (device busy against the step, device time by class).
   Then the detector families: the predictor with the ``mtcnn``, ``hog``
   and ``scrfd`` + ``refine`` detectors (``DETECTOR_FAMILIES``) on the two
   clips, as above (card vs CPU in float32, one warp a clip, ms a clip);
   the JAX package's slow acceptance bars of MTCNN-Lite, HOG and the
   cascade with the committed weights, on the card; detector training at
   the CLI's defaults (320² ``write_corpus`` scenes, B = 32, AdamW lr
   1e-3, clip 5.0, float32): one SCRFD step against a float64 step on the
   CPU within ``TRAIN_LIMITS``, 20 steps each of scrfd, mtcnn and refine with
   the loss falling, ms a step, images/s and peak memory, and one
   ``fit_hog_template`` of ``HOG_FIT_SCENES`` scenes held to the HOG bar;
   the train step of T fed by ``HostLoader``, ``DeviceLoader`` and
   ``CachedDeviceLoader`` over 1,024 PNG faces (first batches equal, ms a
   step of each in turns, one warp launch a step). The native decoder is
   not driven: the H100 machine it was written for has no OpenCV headers
   to build it with.
   Then the ViT fallback family (ViT-B/16 at 224², full width and depth,
   seeded): the predictor with the ``hog`` detector and the ViT on the two
   clips (the 5-frame clip card vs CPU in float32, num_faces equal and
   fake_prob within PREDICTOR_PROB_TOL; ms a clip in bf16, one warp launch
   a clip); one AdamW step at batch 4 on the card in float32 without TF32
   against a float64 step on the CPU within ``TRAIN_LIMITS``; ms a step,
   images/s and peak memory of the bf16 step at B = 32 (augmentation on,
   one warp launch a step), twice, beside T's.
   Then data parallelism and the slice-13 CLIs (the machine has one card:
   two ranks or two replicas share it, so these check semantics and their
   times are one-card context): the train step of the training
   configuration's B4 at 224² (augmentation and dropout on) in two ranks
   spawned on the card over gloo, DP_BATCH drawn faces (half a rank), in
   float32 at A = 1 and 2 against the one-process step on the same rows
   within ``TRAIN_LIMITS`` (the ranks bit for bit equal), a control with
   the BatchNorm all-reduce switched off (local statistics) that must
   break them, one bf16 step of each timed; path A through
   ``make_sharded`` over [card, card] against ``forward`` on SS_BATCH
   frames (``has_face`` equal, the int8 limits, twice path A's launches,
   a one-device mesh giving ``forward``); the B4 train state through
   ``utils/orbax_io`` bit for bit; ``run_pipeline`` on 16 drawn images
   and a cv2-written video and ``preprocess_dataset`` on a drawn gen_ai
   tree, each on the card against ``--device cpu`` in float32 (the rows,
   labels and splits equal, fake_prob within CLI_PROB_TOL, the aligned
   faces within CLI_FACE_TOL).
   Then the slice-14 modules: every family's acceptance bars through
   ``acceptance.py`` (SCRFD, S2D-Lite, MTCNN-Lite, HOG, the cascade and the
   packaged classifier's held-out AUC), committed weights, on the card;
   ``promote_weights`` accepting a copy of the committed MTCNN-Lite file
   into a temporary directory and refusing a candidate with zeroed
   convolution weights (the bars in a child process on the card; the
   destination and the shipped directory unchanged); ``profile_e2e`` on
   path A at B = 128 (each stage's host and device ms and launches: 25
   ``int8_conv``, one ``crop_frac``, one warp, 44 ``int8_gemm`` a batch;
   the composed stages against ``forward``; the classify sweep); the four
   probes at reduced batch (every mode and combo must run);
   ``measure_crop_fidelity`` on FIDELITY_SCENES scenes over all twelve
   configurations, each configuration's kernels equal to their plain
   versions fed the card's geometry; ``experiment_pipeline_ab`` by
   subprocess at the smallest size with two seeds; ``bench_dataloader``
   (cv2 path) and ``diag_rss`` for two epochs.
5. Checks each pipeline on the card against the same pipeline on the CPU
   (plain kernel versions, float32) on two frames with drawn faces (three
   faces of different sizes a frame for the multi-face path, two of path
   H's scenes for path H).
6. Serves ten paths for a few batches at B = 32 and B = 128, twice, in
   turns (A, B, bf16, C, D, E, F, G, H, I, then back) — all but I
   EfficientNet-B4 at full width and depth (seeded weights), committed
   detector weights, 320² detection on 640² uint8 frames, bf16 — with
   every kernel's launch count reset just before and read just after each:
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
     only (96 faces a batch);
   * path G, path A with ``use_s2d_early``: the stem and blocks 0-2 on the
     space-to-depth layout, the tail calibrated on G's own activations;
   * path H, the class default geometry with ``detector_arch="mtcnn"`` and
     the committed MTCNN-Lite weights at a 640² detection canvas (pool
     ratio 1), on drawn scenes whose faces have MTCNN-Lite's training
     sizes (36-110 px; the CPU's count of frames with a face is printed);
   * path I, path B with ViT-B/16 (224², full width and depth, seeded) in
     place of the B4: its profile classes the device time by kernel (GEMM,
     attention softmax, GELU, reductions) and by module (detector, the
     whole ViT, LayerNorm, attention, the MLP products; ``record_function``
     ranges from forward hooks), sets the ViT's device time beside its
     bound (operations at 989 TFLOP/s bf16), and one batch runs under
     ``utils/profiling.trace``, whose Chrome trace must name the crop and
     warp kernels.
   Then drives what no pipeline runs: the single-block prototype on two B4
   block shapes, held to the unfused module, and the "uw" warp through
   ``warp_affine_windowed(tap_construction="uw")``, held to "uw16".
7. Where the serving time goes: one batch per path and size under
   ``torch.profiler`` — device busy time against the batch time (the idle
   share), device time by kernel class (and, on path I, by module), top
   kernels.

Prints its wall time, one JSON line with the kernels' numbers, then
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero without a
card, when a kernel does not build or disagrees, or when any check fails.
Writes the same numbers and the profile to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

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
# agree bit for bit; the crops' limit is one bf16 ulp of a [128, 256) pixel.
# The warps repeat their plain versions' operation order and the int8
# products have exact s32 sums: no difference at all is allowed there.
CROP_TOL, POOL_TOL, WARP_TOL, INT8_TOL = 1.0, 1.0, 0.0, 0.0
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
    "G s2d + int8 headline": {**_INT8, "crop_frac": 1, "warp_affine_legacy": 1},
    "H mtcnn detector": {"crop_pool": 1, "warp_affine_legacy": 1},
    "I ViT-B/16, default pooled warp": {"crop_pool": 1, "warp_affine_legacy": 1},
}.items()}
I_PATH = "I ViT-B/16, default pooled warp"
# The ViT fallback family at the reference's fallback size (HuggingFace
# ViT-B/16, 224²), full width and depth, seeded.
VIT_MODEL = {"type": "vit", "feature_extractor": {"variant": "base16", "image_size": 224},
             "classifier": {"num_classes": 2}}
# Batch sizes each path is served at (and profiled at, in the first round).
PATH_BATCHES = {path: (BATCH,) if path.startswith(("D", "F")) else PROFILE_BATCHES
                for path in EXPECTED}
# Fused-kernel shapes of phase 3: (variant, flat block index, input size,
# batch). B4 blocks 1-7 at the 192² path's resolutions; B4 block 17 at 14² is
# the widest block of the 224² path (cexp 960); b6 block 24 (cout 200, cexp
# 1200) and b7 block 29 (cout 224, cexp 1344) are the widest blocks the
# fused runner plans for those variants at 224², whose projection runs in
# two groups of output channels (seeded weights of that one block).
FUSED_BLOCKS = (("b4", 1, 96, 128), ("b4", 2, 96, 128), ("b4", 3, 48, 128), ("b4", 6, 48, 128),
                ("b4", 7, 24, 128), ("b4", 17, 14, 32), ("b6", 24, 14, 32), ("b7", 29, 14, 32))
PROTO_BLOCKS = ((3, 48, 128), (12, 14, 128))
# GEMM shapes of the tail at B = 128 (rows = 128 x H x W): largest M, a
# mid shape, largest K. The detector's convolutions are recorded from path
# A's runner (detector_conv_shapes).
GEMM_SHAPES = ((128 * 576, 56, 336), (128 * 144, 160, 960), (128 * 36, 2688, 448))

# Kernel-name fragments → class for the profile, first match wins.
KERNEL_CLASSES = (
    ("host <-> device copy", ("memcpy",)),
    ("crop_frac (port kernel)", ("crop_frac_band_kernel<0>",)),
    ("crop_frac_mxu (port kernel)", ("crop_frac_band_kernel<1>",)),
    ("crop_pool (port kernel)", ("crop_pool_band_kernel", "crop_pool_kernel")),
    ("warp_affine_legacy (port kernel)", ("warp_tile_kernel<0>",)),
    ("warp_affine_uw / uw16 (port kernel)", ("warp_tile_kernel<1>",)),
    ("warp_affine_int8 (port kernel)", ("warp_tile_kernel<2>",)),
    ("crop / warp (port kernel, construction not in the name)",
     ("crop_frac_band_kernel", "warp_tile_kernel")),
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
    # Now and then a profile comes back without its device records, or
    # without some of them (a kernel counted 19 times in 20 calls): every
    # call launches the same kernels, so a count that is no multiple of the
    # calls means lost records, and the profile is taken again. Late in a
    # run every try may lose one record of a kernel (seen from the
    # whole-frame warp phase on); then each kernel's mean over the launches
    # recorded, times its launches a call, stands in.
    events = []
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
        events = got or events  # a try that saw nothing keeps the one before
        if got and all(ev.count % iters == 0 for ev in got):
            break
        time.sleep(0.2)
    per_call = {ev.key: round(ev.count / iters) for ev in events}
    if not events or min(per_call.values()) < 1:
        t = time_ms(fn, iters, warmup=0, repeats=3)
        print(f"device_ms: the profiler lost device records in five tries (the last saw "
              f"{sorted((ev.key[:48], ev.count) for ev in events)} in {iters} calls); "
              f"{t['median']:.4f} ms from CUDA events instead (host enqueue included)")
        return {"ms": t["median"], "call_ms": t["median"], "launches": float("nan"),
                "kernels": {}, "source": "CUDA events"}
    lost = sum(per_call[ev.key] * iters - ev.count for ev in events)
    if lost:
        print(f"device_ms: the profiler lost {lost} of {sum(per_call.values()) * iters} device "
              f"records in five tries; the means of the recorded launches stand in")
    kernels = {ev.key: {"ms": ev.self_device_time_total / 1e3 / ev.count * per_call[ev.key],
                        "launches": per_call[ev.key]} for ev in events}
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
    """One of the ten served configurations. Paths A, E and G are
    calibrated as the JAX benchmark calibrates its headline (8 uniform-noise
    faces, 4 uniform-noise frames, seeded; G's tail on its own s2d
    activations) unless ``scales`` hands the scales over."""
    from deepfake_vit_tpu_torch.configs import MODEL_CONFIG
    from deepfake_vit_tpu_torch.e2e import FusedPipeline

    common = dict(detection_input_size=DETECT, serving_size=SERVING, confidence_threshold=0.0,
                  dtype=dtype, device=device)
    int8 = path.startswith(("A", "E", "G"))
    if int8:
        tail_scales, det_scales = scales or (None, None)
        pipe = FusedPipeline(MODEL_CONFIG, use_int8_tail=True, int8_tail_start=TAIL_START,
                             warp_window=WINDOW, warp_fractional=True, use_int8_detector=True,
                             output_size=FACE, int8_act_scales=tail_scales,
                             det_act_scales=det_scales, use_s2d_early=path.startswith("G"),
                             warp_tap_mode="int8" if path.startswith("E") else "legacy", **common)
    elif path.startswith(("B", "D", "F", "H", "I")):  # default warp arguments and face size
        extra = (dict(detector_arch="lite", keep_top_k=MULTI_K, warp_tap_mode="uw16")
                 if path.startswith("F") else {})
        if path.startswith("H"):  # MTCNN-Lite serves at a pool ratio of 1: a 640² canvas
            extra = dict(detector_arch="mtcnn")
            common["detection_input_size"] = SERVING
        config = {"model": VIT_MODEL} if path.startswith("I") else MODEL_CONFIG
        pipe = FusedPipeline(config, use_fused_backbone=path.startswith("D"), **extra,
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


def drawn_face_frames(n: int, size, seed: int, faces: int = 1) -> np.ndarray:
    """n uint8 RGB frames with ``faces`` upright drawn faces each on a colour
    gradient (skin ellipse, sclera and iris, brows, nose, mouth): the
    committed detectors find these with confidence near 1, so the chosen
    faces are clear on the card and on the CPU alike. Several faces get a
    vertical band of the frame each and sizes that differ by about 1.4×.
    ``size`` is the side of a square frame or its (height, width)."""
    h, w = (size, size) if isinstance(size, int) else size
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)

    def ellipse(img, cx, cy, ax, ay, color):
        img[((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0] = color

    band = w / faces
    for i in range(n):
        base, gx, gy = rng.uniform(40, 200, 3), rng.normal(0, 0.1, 3), rng.normal(0, 0.1, 3)
        img = np.clip(base + gx * xs[..., None] + gy * ys[..., None], 0, 255).astype(np.float32)
        for k in range(faces):
            if faces == 1:  # the draws of the one-face frames the earlier paths check
                hw = rng.uniform(0.08, 0.22) * min(h, w)
            else:
                hw = min(0.22 * min(h, w), band / 3.4) / 1.4 ** k * rng.uniform(0.9, 1.0)
            hh = hw * rng.uniform(1.15, 1.4)
            cx = rng.uniform(band * k + 1.6 * hw, band * (k + 1) - 1.6 * hw)
            cy = rng.uniform(1.2 * hh, h - 1.2 * hh)
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


def detector_conv_shapes(run, *args):
    """Call ``run(*args)`` and record every launch of the int8 detector's
    convolution in it: [(H, Cin, Cout, k, stride)] in launch order, and
    whether the runner's kernels are K-major (the HWIO view of a
    contiguous (Cout, k, k, Cin) tensor)."""
    from deepfake_vit_tpu_torch.models import scrfd_int8

    seen, layouts = [], set()
    real = scrfd_int8.int8_conv

    def recording(xq, kq, sx, sw, bias=None, stride=1):
        if xq.shape[1] != xq.shape[2]:
            fail(f"int8_conv on a non-square image {tuple(xq.shape)}")
        seen.append((xq.shape[1], xq.shape[3], kq.shape[3], kq.shape[0], stride))
        layouts.add(kq.permute(3, 0, 1, 2).is_contiguous())
        return real(xq, kq, sx, sw, bias, stride)

    scrfd_int8.int8_conv = recording
    try:
        run(*args)
    finally:
        scrfd_int8.int8_conv = real
    if len(layouts) != 1:
        fail(f"the detector keeps its kernels in more than one layout: {layouts}")
    return seen, layouts.pop()


def check_int8_conv(ik, dev, convs, k_major: bool, batch: int = 128) -> list:
    """int8_conv vs its plain version at each distinct shape of ``convs``
    (the detector's launches, (H, Cin, Cout, k, stride)), the kernels laid
    out as the runner keeps them, and the per-batch sums over all of
    ``convs``. No PyTorch call computes an s8 convolution on CUDA; the bf16
    cuDNN convolution of the same shape is printed as context only: it is a
    different function."""
    import torch.nn.functional as F

    from deepfake_vit_tpu_torch.models.layers import same_pads

    rows, per_shape = [], {}
    for shape in dict.fromkeys(convs):  # distinct, in launch order
        H, cin, cout, k, stride = shape
        name = f"{H}² {cin}→{cout} {k}×{k} s{stride}"
        g = torch.Generator(device="cpu").manual_seed(H + cin + cout + k)
        xq = torch.randint(-127, 128, (batch, H, H, cin), generator=g, dtype=torch.int8).to(dev)
        kq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8).to(dev)
        if k_major:
            kq = kq.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
        sx = torch.tensor([0.031], device=dev)
        sw = (torch.rand(cout, generator=g) * 0.01 + 0.001).to(dev)
        b = torch.randn(cout, generator=g).to(dev)
        got = ik.int8_conv(xq, kq, sx, sw, b, stride)
        torch.cuda.synchronize()
        err = (got - ik.int8_conv_plain(xq, kq, sx, sw, b, stride)).abs().max().item()
        t = time_ms(lambda: ik.int8_conv(xq, kq, sx, sw, b, stride))
        d = device_ms(lambda: ik.int8_conv(xq, kq, sx, sw, b, stride), "int8_conv")
        one_launch("int8_conv", d, "int8_conv_kernel")
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
        n = convs.count(shape)
        # An earlier checkout timed through tools/kernel_times.py may have no plan.
        plan = ik.int8_conv_plan(batch * Ho * Ho, k * k * cin, cout, cin) if hasattr(
            ik, "int8_conv_plan") else None
        print(f"int8_conv {name}, B = {batch}, {n} a batch"
              + (f", tile {plan.tile_m}x{plan.tile_n}, {plan.blocks} blocks, {plan.copy_bytes}-byte "
                 f"copies" if plan else "")
              + f": max_abs {err} (tol {INT8_TOL}) kernel_ms {fmt(t)} device_ms {fmt_dev(d)} "
              f"plain_ms {fmt(plain)} bound_us {b_ms * 1e3:.2f} ({by}), {d['ms'] / b_ms:.1f}x; "
              f"context, a different function: bf16 cuDNN convolution of this shape {fmt(cudnn)} ms")
        if not err <= INT8_TOL:
            fail(f"int8_conv disagrees with its plain version at {name}: {err}")
        per_shape[shape] = (d["ms"], t["median"], b_ms)
        rows.append({"shape": f"{name}, B = {batch}", "launches_per_batch": n,
                     "max_abs_err": err, "ms": t["median"], "ms_range": [t["min"], t["max"]],
                     "device_ms": d["ms"], "device_kernels": d["kernels"],
                     "plain_ms": plain["median"], "bound_ms": b_ms, "bound_by": by,
                     "library_ms": None, "context_bf16_cudnn_ms": cudnn["median"],
                     "plan": plan._asdict() if plan else None})
    batch_dev, batch_ms, batch_bound = (sum(per_shape[c][i] for c in convs) for i in range(3))
    print(f"int8_conv, the detector's {len(convs)} launches a batch of {batch}: device_ms "
          f"{batch_dev:.4f} (kernel_ms {batch_ms:.4f}) against a summed bound of "
          f"{batch_bound:.4f} ms, {batch_dev / batch_bound:.2f}x")
    rows[0]["batch"] = {"launches": len(convs), "device_ms": batch_dev, "ms": batch_ms,
                        "bound_ms": batch_bound}
    return rows


def check_crop_pool(wk, frames_flat, A_inv, dev, check_launches: bool = True) -> list:
    """crop_pool vs its plain version at path B's shape (128 faces, one
    frame each, frame_idx None) and path F's (96 face slots sharing 32
    frames, 3 a frame): 640² frames, window 160; one device launch a call
    unless ``check_launches`` is cleared (for an earlier checkout's kernels,
    which launched more). Returns one row a shape."""
    from deepfake_vit_tpu_torch.ops.warp import max_window_levels, window_geometry

    N, H, WC = frames_flat.shape
    C, W = 3, WC // 3
    levels = max_window_levels((H, W), POOL_WINDOW)
    shapes = (("B", A_inv, None), ("F", seeded_geometry(BATCH * MULTI_K, 7, dev),
                                   torch.arange(BATCH * MULTI_K, device=dev).int() // MULTI_K))
    rows = []
    for path, A, fidx in shapes:
        n = A.shape[0]
        level, y0s, x0s, _ = window_geometry(A, POOL_FACE, (H, W), POOL_WINDOW, levels, y_align=16)
        idx = torch.arange(n, device=dev)
        y0_l0 = y0s[level.long(), idx] << level
        x0 = x0s[level.long(), idx]
        hist = torch.bincount(level.long(), minlength=levels).tolist()
        if min(hist) == 0:
            fail("seeded geometry must cover every mip level")
        frames = frames_flat if fidx is None else frames_flat[:BATCH]
        args = (frames, y0_l0, x0, level, POOL_WINDOW, C)
        kw = {} if fidx is None else {"frame_idx": fidx}
        plain_idx = idx.int() if fidx is None else fidx
        got = wk.crop_pool(*args, **kw)
        torch.cuda.synchronize()
        plain_args = (frames, y0_l0.int(), x0.int(), level.int(), POOL_WINDOW, C, plain_idx)
        err = (got.float() - wk.crop_pool_plain(*plain_args).float()).abs().max().item()
        t = time_ms(lambda: wk.crop_pool(*args, **kw))
        d = device_ms(lambda: wk.crop_pool(*args, **kw), "crop_pool")
        if check_launches:
            one_launch("crop_pool", d, "crop_pool_band_kernel")
        plain = time_ms(lambda: wk.crop_pool_plain(*plain_args), iters=3, repeats=3)
        # The source pixels on the frame that the face's 4^l blocks cover,
        # read once; the output written once; 16 bytes of scalars a face.
        side = (1 << level.long())
        span = lambda lo, size: (torch.clamp((lo + POOL_WINDOW) * side, max=size)
                                 - torch.clamp(lo * side, min=0)).clamp_min(0)
        on_frame = span(y0_l0.long() // side, H) * span(x0.long(), W)
        nbytes = int(on_frame.sum().item()) * C * 2 + n * POOL_WINDOW ** 2 * C * 2 + n * 16
        b_ms, by = bound(nbytes)
        shape = (f"{n} faces{'' if fidx is None else f' sharing {BATCH} frames'}, {H}² frames, "
                 f"window {POOL_WINDOW}, levels {hist}")
        print(f"crop_pool, path {path} shape, {shape}: max_abs {err} (tol {POOL_TOL}) kernel_ms "
              f"{fmt(t)} device_ms {fmt_dev(d)} plain_ms {fmt(plain)} bound_us {b_ms * 1e3:.2f} "
              f"({nbytes} bytes), {d['ms'] / b_ms:.2f}x; no single PyTorch call computes it")
        if not err <= POOL_TOL:
            fail(f"crop_pool disagrees with its plain version at path {path}'s shape: {err}")
        rows.append({"shape": shape, "max_abs_err": err, "ms": t["median"],
                     "ms_range": [t["min"], t["max"]], "device_ms": d["ms"],
                     "device_kernels": d["kernels"], "plain_ms": plain["median"],
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    return rows


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


def block_inputs(fs, bb, variant: str, idx: int, h: int, B: int, g, dev):
    """One block of phase 3: B4's own block ``idx`` of ``bb``, or that block
    of a wider variant with seeded weights; its plan, folded weights and a
    seeded (B, h, h, cin) bf16 input drawn from ``g``."""
    from deepfake_vit_tpu_torch.models.efficientnet import MBConvBlock, block_args
    from deepfake_vit_tpu_torch.models.layers import init_weights

    if variant == "b4":
        blk, args = getattr(bb, f"block_{idx}"), bb.blocks[idx]
    else:  # one block of a wider variant, seeded
        args = block_args(variant)[idx]
        blk = init_weights(MBConvBlock(**args), idx).to(dev).eval()
    bp = fs.block_plan_from_args(args)
    weights = fs.fold_block_weights(blk, bp)
    x = torch.randn((B, h, h, bp.cin), generator=g).to(dev).to(torch.bfloat16)
    return blk, args, bp, weights, x


def check_fused(fs, fm, dev, check_launches: bool = True):
    """run_stem, run_block and fused_mbconv against their plain versions at
    B4's shapes, on seeded weights and inputs (``check_launches`` goes to
    check_stem). Returns (stem rows, block rows, prototype rows)."""
    from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
    from deepfake_vit_tpu_torch.models.layers import init_weights

    bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
    stem_rows = check_stem(fs, bb, dev, check_launches)
    # The blocks' inputs follow the first stem input in one seeded stream.
    g = torch.Generator(device="cpu").manual_seed(3)
    torch.randint(0, 256, (STEM_SHAPES[0][0], *STEM_SHAPES[0][1], 3), generator=g)

    def block_case(label, variant, idx, h, B):
        blk, args, bp, weights, x = block_inputs(fs, bb, variant, idx, h, B, g, dev)
        if label == "run_block":
            run, run_plain = (lambda: fs.run_block(bp, x, weights),
                              lambda: fs.run_block_plain(bp, x, weights))
        else:
            ratio = args["expand_ratio"]
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
        shape = (f"{variant.upper()} block {idx}, B = {B}, {h}² -> {h // bp.stride}², k{bp.kernel} "
                 f"{bp.cin} -> {bp.cexp} -> {bp.cout}")
        return fused_row(label, shape, agree, t, d, plain, b_ms, by, eager)

    block_rows = [block_case("run_block", *case) for case in FUSED_BLOCKS]
    proto_rows = [block_case("fused_mbconv", "b4", *case) for case in PROTO_BLOCKS]
    return stem_rows, block_rows, proto_rows


# The stem at path C's faces (B = 128, 192²) and path D's (B = 32, 224²).
STEM_SHAPES = ((128, FACE), (BATCH, POOL_FACE))


def check_stem(fs, bb, dev, check_launches: bool = True) -> list:
    """run_stem vs its plain version at STEM_SHAPES on B4's seeded stem and
    seeded faces; one device launch a call unless ``check_launches`` is
    cleared (as for check_crop_pool). Context, not the same function
    (no SiLU): one cuDNN convolution in bf16, channels-last, with the folded
    weights and bias, on the input padded beforehand (the port never calls
    it)."""
    import torch.nn.functional as F

    from deepfake_vit_tpu_torch.ops.image import normalize_imagenet

    g = torch.Generator(device="cpu").manual_seed(3)
    sw = fs.fold_stem_weights(bb)
    c0 = sw[0].shape[0]
    w4 = sw[0].float().reshape(c0, 3, 3, 3).permute(0, 3, 1, 2).to(torch.bfloat16)
    w4 = w4.contiguous(memory_format=torch.channels_last)
    rows = []
    for B, face in STEM_SHAPES:
        faces = torch.randint(0, 256, (B, *face, 3), generator=g, dtype=torch.uint8).to(dev)
        x = normalize_imagenet(faces.float() / 255.0).to(torch.bfloat16)
        got = fs.run_stem(x, sw)
        torch.cuda.synchronize()
        agree = fused_agreement("run_stem", got, fs.run_stem_plain(x, sw))
        t = time_ms(lambda: fs.run_stem(x, sw))
        d = device_ms(lambda: fs.run_stem(x, sw), "fused_stem")
        if check_launches:
            one_launch("run_stem", d, "fused_stem_kernel")
        plain = time_ms(lambda: fs.run_stem_plain(x, sw), iters=3, repeats=3)
        x_nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            eager = time_ms(lambda: F.silu(bb.stem_bn(bb.stem_conv(x_nchw))), iters=5, repeats=3)
        x_pad = F.pad(x_nchw, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        cudnn = device_ms(lambda: F.conv2d(x_pad, w4, sw[1].to(torch.bfloat16), stride=2))
        ho = face[0] // 2
        taps = valid_taps(face[0], ho, 3, 2, 0)
        b_ms, by = bound(x.numel() * 2 + B * ho * ho * c0 * 2 + sw[0].numel() * 2 + c0 * 4,
                         2.0 * B * taps * taps * 3 * c0, BF16_OPS_PER_S)
        row = fused_row("run_stem", f"({B}, {face[0]}, {face[1]}, 3) -> {c0} channels", agree, t,
                        d, plain, b_ms, by, eager)
        print(f"run_stem ({B}, {face[0]}², 3): {d['ms'] / b_ms:.2f}x the bound; context, not the "
              f"same function (no SiLU): one bf16 cuDNN conv2d, channels-last, folded weights "
              f"and bias, device_ms {fmt_dev(cudnn)}")
        row["context_cudnn_conv_device_ms"] = cudnn["call_ms"]
        rows.append(row)
        del x, x_nchw, x_pad, faces, got
    return rows


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
    one_launch(name, d, "warp_tile_kernel")
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


# The warp geometry phase: (name, source side, roll in degrees, scale in
# source pixels per output pixel, mirrored, offset of the output centre from
# the source centre in source pixels). 128² crops go to FACE as on path A;
# the last warps a whole 640² frame at a down-scale of 3, whose tiles'
# source boxes outgrow the plan's budget, so the kernel reads their taps
# from device memory.
WARP_GEOMETRIES = (
    ("roll 0°", WINDOW, 0.0, 0.62, False, (0.0, 0.0)),
    ("roll 30°", WINDOW, 30.0, 0.62, False, (0.0, 0.0)),
    ("roll 90°", WINDOW, 90.0, 0.62, False, (3.0, -2.0)),
    ("roll 180°", WINDOW, 180.0, 0.62, False, (0.0, 0.0)),
    ("mirror, roll 12°", WINDOW, 12.0, 0.62, True, (0.0, 0.0)),
    ("wholly outside", WINDOW, 20.0, 0.62, False, (400.0, -300.0)),
    ("partly outside", WINDOW, 45.0, 0.8, False, (70.0, 30.0)),
    ("down-scale 3, whole frame", SERVING[0], 10.0, 3.0, False, (0.0, 0.0)),
)


def geometry_affines(cases, out_size, dev) -> torch.Tensor:
    """dst→src affines (N, 2, 3) of WARP_GEOMETRIES entries."""
    A = np.zeros((len(cases), 2, 3))
    for k, (_, side, roll, scale, mirror, offset) in enumerate(cases):
        th = np.deg2rad(roll)
        R = scale * np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        if mirror:
            R[:, 0] *= -1.0
        c_out = np.asarray([(out_size[1] - 1) / 2, (out_size[0] - 1) / 2])
        A[k, :, :2] = R
        A[k, :, 2] = (side - 1) / 2 + np.asarray(offset) - R @ c_out
    return torch.as_tensor(A, dtype=torch.float32, device=dev)


def check_warp_geometry(wk, dev) -> dict:
    """Every warp construction on WARP_GEOMETRIES, bit for bit against its
    plain version; the branch each tile took, reported by the kernel, held
    to the host's prediction (``warp_tile_box``). Fails unless both the
    staged and the device-memory branch ran."""
    g = torch.Generator(device="cpu").manual_seed(12)
    rows, branch_total = {}, {1: 0, 2: 0}
    for side in sorted({c[1] for c in WARP_GEOMETRIES}):
        cases = [c for c in WARP_GEOMETRIES if c[1] == side]
        img = (torch.rand((len(cases), side, side, 3), generator=g) * 255).to(torch.bfloat16).to(dev)
        A = geometry_affines(cases, FACE, dev)
        coeffs = A.reshape(-1, 6)
        box = wk.warp_tile_box(coeffs, FACE, (side, side), 3)
        predicted = torch.where(box.staged, 1, 2).to(torch.int32)
        for k, case in enumerate(cases):
            staged = int(box.staged[k].sum().item())
            print(f"warp geometry {case[0]!r} ({side}² source -> {FACE[0]}²): {staged} tiles "
                  f"staged, {box.staged[k].numel() - staged} read from device memory; largest "
                  f"box {int(box.box_bytes[k].max().item())} bytes (budget "
                  f"{wk.warp_plan(3).box_budget})")
        for name in wk.WARP_KERNELS:
            got, branch = wk.warp_tile_branches(name, img, A, FACE, inverse=True)
            torch.cuda.synchronize()
            plain = {"legacy": wk.warp_affine_legacy_plain, "int8": wk.warp_affine_int8_plain}.get(
                name, wk.warp_affine_uw_plain)
            want = plain(img, coeffs, FACE)
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                fail(f"{name} on the warp geometries of {side}² sources differs from its plain "
                     f"version: max abs {err}")
            if not torch.equal(branch, predicted):
                fail(f"{name}: the tiles' branches differ from warp_tile_box's prediction")
            for k, case in enumerate(cases):
                if case[0] == "wholly outside" and bool(got[k].any()):
                    fail(f"{name}: a warp from wholly outside the source is not all zeros")
            for b in (1, 2):
                branch_total[b] += int((branch == b).sum().item())
            rows[f"{name}, {side}² sources"] = {"max_abs_err": err,
                                                "tiles_staged": int((branch == 1).sum().item()),
                                                "tiles_device_memory": int((branch == 2).sum().item())}
            print(f"warp geometry, {name}, {side}² sources: max_abs {err} against the plain "
                  f"version; tiles staged {rows[f'{name}, {side}² sources']['tiles_staged']}, "
                  f"from device memory {rows[f'{name}, {side}² sources']['tiles_device_memory']}")
    if not branch_total[1] or not branch_total[2]:
        fail(f"the warp geometry phase did not take both branches: {branch_total}")
    return rows


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


# The predictor's clips (drawn faces): a video at 1280×720, letterboxed
# into the 640² detection canvas, and one at 640²; the whole-frame warp
# phase adds two 1920×1080 frames. Frames, height, width, seed. The seeds
# give large faces whose tiles outgrow the warp's 24 KiB staging budget
# (98 tiles of the 720p clip, all of the 1080p frames), and detection
# scores at least 0.12 from the 0.5 threshold (24 of the 32 640² frames
# hold a face above it; on the CPU, with the committed SCRFD).
PREDICTOR_CLIPS = {"1280x720": (5, 720, 1280, 34), "640x640": (BATCH, 640, 640, 37)}
WHOLE_FRAME_EXTRA = {"1920x1080": (2, 1080, 1920, 33)}
PREDICTOR_PROB_TOL = 0.02  # fake_prob, card vs CPU (tests/test_torch_e2e.py's bound)
# Aligned uint8 faces, card vs CPU: the detections differ by about 2e-4 px
# (float32 convolutions in two orders); the warp's bf16 taps and sums are
# step functions of the coordinates, so such a shift moves an output by up
# to a tap step and two bf16 roundings (about 2.5 levels, 3 after the
# truncation to uint8) at a few per cent of the pixels, by more than one
# level at about 0.1 % (CPU, landmarks moved by 2e-4 px).
ALIGNED_U8_TOL = 3.0
# The preprocess_dataset CLI's aligned faces, card vs --device cpu, in grey
# levels.
CLI_FACE_TOL = 2.0
PREDICTOR_REPEATS = 3


def clip_frames(spec) -> np.ndarray:
    n, h, w, seed = spec
    return drawn_face_frames(n, (h, w), seed)


def s2d_prefix_context(dev) -> dict:
    """Path G's s2d stages (``S2DEarlyRunner`` of a seeded B4, 192² faces)
    against the stock stem and blocks 0-2 they replace, on the same bf16
    faces (B = 128): the device time of each and their largest difference
    (context only: the s2d stages are held to JAX in
    tests/test_torch_s2d_early.py)."""
    from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.models.s2d_early import S2DEarlyRunner
    from deepfake_vit_tpu_torch.ops.image import normalize_imagenet

    backbone = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
    runner = S2DEarlyRunner(backbone, image_size=FACE[0])
    resume = runner.resume_block
    g = torch.Generator(device="cpu").manual_seed(41)
    faces = torch.randint(0, 256, (128, *FACE, 3), generator=g, dtype=torch.uint8).to(dev)
    x = normalize_imagenet(faces.float() / 255.0).to(torch.bfloat16)

    def stock():
        with torch.inference_mode():
            return backbone(x, stop_block=resume)

    s2d_d, stock_d = device_ms(lambda: runner(x), iters=10), device_ms(stock, iters=10)
    diff = (runner(x).float() - stock().float()).abs().max().item()
    print(f"[context] path G's s2d stages (stem + blocks 0-{resume - 1}) at (128, {FACE[0]}², 3): "
          f"device_ms {fmt_dev(s2d_d)}; the stock blocks they replace {fmt_dev(stock_d)}; "
          f"largest difference {diff:.4f}")
    return {"s2d_device_ms": s2d_d["ms"], "s2d_device_launches": s2d_d["launches"],
            "stock_device_ms": stock_d["ms"], "stock_device_launches": stock_d["launches"],
            "max_abs_diff": diff}


def whole_frame_inputs(dev) -> dict:
    """Per clip of PREDICTOR_CLIPS and WHOLE_FRAME_EXTRA, the frames with a
    face (on the card) and the src→dst affines the predictor's aligner
    warps them with: its detector and aligner (``PREPROCESSING_CONFIG``,
    224² faces) on the card."""
    from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
    from deepfake_vit_tpu_torch.preprocessing.aligner import FaceAligner
    from deepfake_vit_tpu_torch.preprocessing.detector import create_face_detector

    detector = create_face_detector(PREPROCESSING_CONFIG["detection"], device=dev)
    template = PREPROCESSING_CONFIG["alignment"]["reference_landmarks"]
    aligner = FaceAligner(output_size=POOL_FACE, reference_landmarks=template, device=dev)
    warps = {}
    for name, spec in {**PREDICTOR_CLIPS, **WHOLE_FRAME_EXTRA}.items():
        frames = clip_frames(spec)
        dets = detector.batch_detect(list(frames))
        keep = [i for i, d in enumerate(dets) if d is not None]
        if not keep:
            fail(f"no face found in the {name} frames")
        lms = torch.as_tensor(np.stack([dets[i]["landmarks"] for i in keep]), device=dev)
        warps[name] = (torch.as_tensor(frames[keep]).to(dev), aligner._estimate(lms))
    return warps


def predictor_phase(kernels, dev, family: Optional[str] = None) -> dict:
    """DeepfakePredictor.from_packaged (the committed b0 classifier and
    SCRFD, or the detector ``family`` of DETECTOR_FAMILIES) on the card:
    each clip held to the same predictor on the CPU in float32 (num_faces
    identical, fake_prob within PREDICTOR_PROB_TOL, labels equal away from
    the threshold), then served in bf16 on the card with the kernels'
    launches counted (one warp a clip: its frames share a shape) and ms per
    clip on the host clock; then, with the default detector, a B4
    predictor at full width (seeded, bf16) on the 640² clip."""
    from deepfake_vit_tpu_torch.configs import MODEL_CONFIG, PREPROCESSING_CONFIG
    from deepfake_vit_tpu_torch.inference import DeepfakePredictor
    from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path

    config = PREPROCESSING_CONFIG
    if family is not None:
        config = {**config, "detection": {**config["detection"], **DETECTOR_FAMILIES[family]}}
    tag = f"predictor ({family or 'scrfd'} detector)"
    packaged = default_weights_path("classifier")
    clips = {name: clip_frames(spec) for name, spec in PREDICTOR_CLIPS.items()}
    res = {}
    with tf32_off():
        card32 = DeepfakePredictor.from_packaged(packaged, config, dtype=torch.float32,
                                                 device=dev)
        cpu32 = DeepfakePredictor.from_packaged(packaged, config, dtype=torch.float32,
                                                device="cpu")
        for name, frames in clips.items():
            got, want = card32.predict_frames(list(frames)), cpu32.predict_frames(list(frames))
            err = abs(got["fake_prob"] - want["fake_prob"])
            print(f"{tag}, {name} clip of {len(frames)} frames: card vs CPU, float32: "
                  f"num_faces {got['num_faces']} / {want['num_faces']}, fake_prob "
                  f"{got['fake_prob']:.5f} / {want['fake_prob']:.5f} (|diff| {err:.5f}, limit "
                  f"{PREDICTOR_PROB_TOL}), label {got['label']} / {want['label']}")
            if got["num_faces"] != want["num_faces"] or got["num_faces"] == 0:
                fail(f"{tag}, {name}: num_faces {got['num_faces']} on the card, "
                     f"{want['num_faces']} on the CPU")
            if not err <= PREDICTOR_PROB_TOL:
                fail(f"{tag}, {name}: fake_prob differs by {err} between card and CPU")
            if (got["label"] != want["label"]
                    and abs(want["fake_prob"] - cpu32.threshold) > PREDICTOR_PROB_TOL):
                fail(f"{tag}, {name}: label {got['label']} on the card, {want['label']} on "
                     "the CPU")
            res[name] = {"frames": len(frames), "num_faces": got["num_faces"],
                         "card_vs_cpu_fake_prob_err": err}
        del card32, cpu32

    card = DeepfakePredictor.from_packaged(packaged, config, device=dev)
    runs = list(clips.items())
    if family is None:
        b4 = DeepfakePredictor(MODEL_CONFIG, config, device=dev)  # seeded, bf16
        runs.append(("B4, 640x640", clips["640x640"]))
    for name, frames in runs:
        pred = b4 if name.startswith("B4") else card
        listed = list(frames)
        pred.predict_frames(listed)  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        out = pred.predict_frames(listed)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        want = {**dict.fromkeys(KERNEL_NAMES, 0), "warp_affine_legacy": 1}
        if launches != want:
            fail(f"{tag}, {name} clip: launches {launches}, expected {want}")
        if not (out["num_faces"] > 0 and all(math.isfinite(p) for p in out["frame_probs"])):
            fail(f"{tag}, {name} clip: {out['num_faces']} faces, probabilities "
                 f"{out['frame_probs']}")
        t0 = time.perf_counter()
        for _ in range(PREDICTOR_REPEATS):
            pred.predict_frames(listed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PREDICTOR_REPEATS
        print(f"{tag} ({'B4, seeded' if name.startswith('B4') else 'packaged b0'}, bf16), {name} clip "
              f"of {len(frames)} frames: {ms:.2f} ms a clip on the host clock "
              f"({PREDICTOR_REPEATS} clips after one warm-up), {out['num_faces']} faces, "
              f"fake_prob {out['fake_prob']:.5f}; launches a clip {launches}")
        res.setdefault(name, {}).update({"ms_per_clip": ms, "launches_per_clip": launches,
                                         "fake_prob": out["fake_prob"],
                                         "num_faces_bf16": out["num_faces"]})
    return res


def check_whole_frame_warp(wk, warps, out_size) -> list:
    """warp_affine_legacy on whole frames, at the predictor's shapes: bit
    for bit against its plain version, each tile's branch (staged box or
    device memory) as warp_tile_box predicts, and at least one tile in the
    device-memory branch; timed beside F.grid_sample on the same frames and
    grid and against its bytes bound (the source pixels its nonzero taps
    touch, read once; the float32 output written once)."""
    import torch.nn.functional as F

    from deepfake_vit_tpu_torch.ops.umeyama import invert_affine

    rows, device_tiles = [], 0
    for name, (frames, A) in warps.items():
        img = frames.to(torch.bfloat16)
        N, Hs, Ws, C = img.shape
        if Hs * Ws * C >= 2 ** 31:
            fail(f"whole-frame warp, {name}: {Hs * Ws * C} elements a frame")
        coeffs = invert_affine(A).reshape(N, 6).float().contiguous()
        got, branch = wk.warp_tile_branches("legacy", img, A, out_size)
        torch.cuda.synchronize()
        want = wk.warp_affine_legacy_plain(img, coeffs, out_size)
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"whole-frame warp, {name}: differs from its plain version, max abs {err}")
        box = wk.warp_tile_box(coeffs, out_size, (Hs, Ws), C)
        if not torch.equal(branch, torch.where(box.staged, 1, 2).to(torch.int32)):
            fail(f"whole-frame warp, {name}: the tiles' branches differ from warp_tile_box")
        staged, from_memory = int((branch == 1).sum().item()), int((branch == 2).sum().item())
        device_tiles += from_memory
        A_inv = coeffs.reshape(N, 2, 3)  # the wrapper then launches the kernel alone

        def run():
            return wk.warp_affine_legacy(img, A_inv, out_size, inverse=True)

        t, d = time_ms(run), device_ms(run, "warp_")
        one_launch("warp_affine_legacy", d, "warp_tile_kernel")
        plain = time_ms(lambda: wk.warp_affine_legacy_plain(img, coeffs, out_size), iters=3,
                        repeats=3)
        ii = torch.arange(out_size[0], dtype=torch.float32, device=img.device)[:, None]
        jj = torch.arange(out_size[1], dtype=torch.float32, device=img.device)[None, :]
        a, b, c, dd, e, f = (coeffs[:, k, None, None] for k in range(6))
        grid = torch.stack([(2 * (a * jj + b * ii + c) + 1) / Ws - 1,
                            (2 * (dd * jj + e * ii + f) + 1) / Hs - 1], -1)
        src = img.permute(0, 3, 1, 2).float().contiguous()

        def lib_call():
            return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)

        lib, lib_d = time_ms(lib_call), device_ms(lib_call)
        nbytes = (warp_footprint_bytes(coeffs, Hs, Ws, C, out_size)
                  + N * out_size[0] * out_size[1] * C * 4 + N * 6 * 4)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shape = f"{N} whole {Ws}x{Hs} frames -> {out_size[0]}²"
        print(f"warp_affine_legacy, whole frames, {shape}: max_abs {err} (tol {WARP_TOL}); tiles "
              f"staged {staged}, from device memory {from_memory}; largest box "
              f"{int(box.box_bytes.max().item())} bytes; kernel_ms {fmt(t)} device_ms "
              f"{fmt_dev(d)} plain_ms {fmt(plain)} grid_sample_ms {fmt(lib)} device_ms "
              f"{fmt_dev(lib_d)} bound_us {b_ms * 1e3:.2f} ({nbytes} bytes), "
              f"{d['ms'] / b_ms:.2f}x")
        rows.append({"shape": shape, "max_abs_err": err, "ms": t["median"],
                     "ms_range": [t["min"], t["max"]], "device_ms": d["ms"],
                     "device_kernels": d["kernels"], "plain_ms": plain["median"],
                     "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib["median"],
                     "library_device_ms": lib_d["ms"], "tiles_staged": staged,
                     "tiles_device_memory": from_memory})
        del src, grid, got, want
    if not device_tiles:
        fail("no tile of the whole-frame warps took the device-memory branch")
    return rows


def pipeline_phase(kernels, frames: np.ndarray, dev) -> dict:
    """PreprocessingPipeline(PREPROCESSING_CONFIG)'s one-graph batch on the
    card against the CPU run, float32 (detection) without TF32: the same
    frames with a face, bboxes within 1e-2 px, quality within 1e-2, aligned
    faces within ALIGNED_U8_TOL with fewer than 1 % of the values more than
    one level apart; one warp launch a batch."""
    from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
    from deepfake_vit_tpu_torch.preprocessing.pipeline import PreprocessingPipeline

    with tf32_off():
        card = PreprocessingPipeline(PREPROCESSING_CONFIG, device=dev)
        card.process_batch(list(frames[:2]))  # warm-up
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        got = card.process_batch(list(frames))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k.__name__: k.launches for k in kernels}
        want = PreprocessingPipeline(PREPROCESSING_CONFIG, device="cpu").process_batch(list(frames))
    if launches != {**dict.fromkeys(KERNEL_NAMES, 0), "warp_affine_legacy": 1}:
        fail(f"preprocessing pipeline: launches {launches}, expected one warp_affine_legacy")
    err = {"bbox": 0.0, "aligned": 0.0, "quality": 0.0}
    beyond_one, pixels = 0, 0
    for g, w in zip(got, want):
        if g.success != w.success:
            fail("preprocessing pipeline: a face found on one side only")
        if not g.success:
            continue
        err["bbox"] = max(err["bbox"], float(np.abs(g.bbox - w.bbox).max()))
        diff = np.abs(g.aligned_face.astype(np.int32) - w.aligned_face.astype(np.int32))
        err["aligned"] = max(err["aligned"], float(diff.max()))
        beyond_one, pixels = beyond_one + int((diff > 1).sum()), pixels + diff.size
        err["quality"] = max(err["quality"], abs(g.quality_score - w.quality_score))
    found = sum(g.success for g in got)
    err["aligned_share_beyond_1"] = beyond_one / max(pixels, 1)
    limits = {"bbox": 1e-2, "aligned": ALIGNED_U8_TOL, "aligned_share_beyond_1": 0.01,
              "quality": 1e-2}
    print(f"preprocessing pipeline, fused batch of {len(frames)} frames at "
          f"{frames.shape[2]}x{frames.shape[1]}: {found} faces; card vs CPU, float32: max_abs "
          f"{err} (limits {limits}); {ms:.2f} ms for the batch on the host clock; launches "
          f"{launches}")
    if not found or not all(err[k] <= limits[k] for k in limits):
        fail(f"preprocessing pipeline: the card disagrees with the CPU: {err} > {limits}")
    return {"frames": len(frames), "faces": found, "card_vs_cpu_err": err, "ms_per_batch": ms,
            "launches": launches}


# The training phase (4b): the B4 of the training configuration at 224².
TRAIN_SIZE = (224, 224)
TRAIN_BATCHES = (32, 64)  # the learning run's batch and the configuration's batch
LEARN_STEPS = 30
TIMED_STEPS = 6
# One AdamW step of the B4 at batch 4 (dropout, drop-connect and
# augmentation off) on the card in float32 without TF32, held on each of
# TRAIN_SEEDS's batches to a float64 step of the same batch on the CPU
# (``compare_steps``' measures). A float32 step on the CPU is no yardstick:
# on an H100 80GB HBM3 at 700 W (``tools/train_gates.py``) it lies
# 1.9e-4 / 6.1e-3 / 3.0e-4 / 2.2e-4 / 7.4e-3 of the largest gradient from
# float64 on these batches (its stem and first blocks on two of them),
# the card 1.7e-4 / 2.5e-4 / 3.0e-4 / 2.2e-4 / 4.6e-4 (1 − cosine at most
# 2.9e-8, loss 4.4e-5, grad_norm 1.7e-4, statistics 6.0e-6). The limits
# are the ones the card-vs-CPU gate held on one batch: a sign error moves
# the updates by 2 lr, a wrong lr by about 1 lr.
TRAIN_SEEDS = (22, 24, 25, 27, 29)
TRAIN_LIMITS = {"loss_rel": 1e-4, "grad_norm_rel": 3e-4, "grads_rel": 1e-3, "grads_cos_gap": 1e-6,
                "update_rel": 1e-2, "stats_rel": 5e-5}
# bf16 (the configuration's use_amp): at the seeded init a bf16 rounding
# anywhere moves the whole step's gradient by about its own size (the
# B4's bf16 step against the float32 one, the L2 gap of the gradients
# 1.20-1.45 over five batches, as far as the CPU's bf16 step; 1.33 at
# batch 32, 0.64 with freeze_bn), so the whole step is printed and held
# only to be finite, and the step is held
# piece by piece (``bf16_pieces``), each piece fed the float32 input.
# Five seeded batches on that card: the median stem/block piece 0.00741-
# 0.00747, the worst 0.0152-0.0377, the features 0.034-0.075, the
# classifier (its BatchNorm over 4 samples) 0.028-0.25. Controls, same
# batches: every convolution's output and gradient at 7, 6 and 5
# significant bits (bf16 keeps 8) give medians 0.0097, 0.0157 and 0.0292;
# BatchNorm computed in bf16 gives a median of 0.0103 and a worst piece
# of 0.127-0.234. The median holds the precision; the worst piece holds a
# fault in one piece; the features and the classifier only gross faults.
# The run fails unless the 6-bit and the BatchNorm controls each break a
# limit.
BF16_PIECE_LIMITS = {"blocks_worst": 0.06, "blocks_median": 0.0086, "features": 0.15,
                     "classifier": 0.5}
# The optimizer alone, three AdamW + clip steps, card vs CPU, over lr:
# 7.2e-5 measured; without weight decay 1.68.
OPTIMIZER_LIMIT = 1e-3
LEARN_AUG = {"enabled": True, "random_flip": True, "random_rotation": 5, "color_jitter": 0.1}
# Kernel-name fragments → class for the train step's profile, first match wins.
TRAIN_KERNEL_CLASSES = (
    ("warp_affine_legacy (port kernel)", ("warp_tile_kernel",)),
    ("optimizer (AdamW, clip)", ("multi_tensor", "foreach", "adam")),
    ("convolution (forward and backward)", ("conv", "xmma", "cudnn", "implicit", "winograd",
                                            "dgrad", "wgrad", "fprop", "nhwc", "nchw", "gemm",
                                            "cutlass", "sm90", "sm80")),
    ("BatchNorm / elementwise / reductions", ("elementwise", "reduce", "vectorized", "mean",
                                              "sum", "norm", "unrolled", "index", "where")),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "transpose", "permute", "fill")),
)


def train_faces(n: int, seed: int):
    """n ImageNet-normalized 224² drawn faces (float32 NHWC), labels 0/1 in
    turns with a learnable cue (fake faces carry a white band across their
    top tenth, which flips and 5° rotations keep), and landmarks at the
    aligned positions of the reference layout."""
    from deepfake_vit_tpu_torch.ops.image import normalize_imagenet
    from deepfake_vit_tpu_torch.preprocessing.aligner import (DEFAULT_REFERENCE_LANDMARKS,
                                                              _LANDMARK_ORDER)

    rgb = drawn_face_frames(n, TRAIN_SIZE[0], seed).astype(np.float32)
    labels = np.arange(n, dtype=np.int32) % 2
    rgb[labels == 1, : TRAIN_SIZE[0] // 10] = 255.0
    images = normalize_imagenet(torch.from_numpy(rgb / 255.0)).numpy().astype(np.float32)
    ref = np.asarray([DEFAULT_REFERENCE_LANDMARKS[k] for k in _LANDMARK_ORDER], np.float32)
    lms = np.broadcast_to(ref * np.asarray(TRAIN_SIZE[::-1], np.float32), (n, 5, 2)).copy()
    return {"image": images, "label": labels, "landmarks": lms}


def train_setup(cfg: dict, dtype, dev, seed: int = 0, clip: float = 1.0):
    """The model, optimizer and criterion the train CLI builds from ``cfg``
    (float64: the same initial values, parameters and statistics in float64)."""
    from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.training import create_optimizer, make_criterion

    model = init_weights(create_model_from_config(cfg["model"], dtype=dtype), seed)
    model = (model.double() if dtype == torch.float64 else model).to(dev)
    opt = create_optimizer(model.parameters(), cfg["training"]["optimizer"], gradient_clip=clip)
    crit = make_criterion(cfg["training"]["loss"], torch.ones(2))
    return model, opt, crit


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def round_conv_outputs(model, bits: int) -> None:
    """A control, coarser than bf16: every convolution's output, and the
    gradient that reaches it in the backward, rounded to ``bits``
    significant bits (bf16 keeps 8)."""
    from deepfake_vit_tpu_torch.models.layers import Conv

    drop = 24 - bits

    def coarse(x):
        i = x.float().view(torch.int32)
        return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32).to(x.dtype)

    class Coarse(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return coarse(x)

        @staticmethod
        def backward(ctx, g):
            return coarse(g)

    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(lambda module, inputs, out: Coarse.apply(out))


def bn_in_input_dtype(model) -> None:
    """A faulty control: every BatchNorm computes its statistics and its
    output in the activations' dtype (bf16) instead of float32."""
    from deepfake_vit_tpu_torch.models.layers import BatchNorm

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training and not self.frozen:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        else:
            mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.to(x.dtype).view(shape)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = forward.__get__(m)


def one_train_step(cfg, dtype, dev, batch) -> dict:
    """One step of the train CLI's step function (no augmentation); the
    metrics, the clipped gradients, each parameter's update and the
    running statistics after."""
    from deepfake_vit_tpu_torch.models.bridge import export_flax_variables
    from deepfake_vit_tpu_torch.training import TrainState, make_train_step

    model, opt, crit = train_setup(cfg, dtype, dev)
    if hasattr(model, "feature_extractor"):  # a ViT has no drop-connect
        model.feature_extractor.backbone.drop_connect_rate = 0.0
    p0 = {n: p.detach().to("cpu", torch.float64, copy=True) for n, p in model.named_parameters()}
    metrics = make_train_step(model, crit, opt)(TrainState(), batch, 0)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.double().cpu().numpy() for n, p in model.named_parameters()},
           "update": {n: (p.detach().double().cpu() - p0[n]).numpy()
                      for n, p in model.named_parameters()},
           "batch_stats": flat_tree(export_flax_variables(model)["batch_stats"])}
    del model, opt
    return out


def compare_steps(got: dict, want: dict, lr: float) -> dict:
    """Two steps' gaps: loss and grad_norm relative; gradients as max |Δ|
    over the largest |g| and as 1 − the cosine of the two gradient
    vectors; the updates on the elements whose reference gradient is at
    least 1e-3 of the largest (Adam moves the others by float noise's
    sign) as max |Δ| over lr, and the share of them whose update moved the
    other way; running statistics as max |Δ| over the largest (0 for a
    model without any, as the ViT)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    gmax = max(np.abs(g).max() for g in want["grads"].values())
    g1 = np.concatenate([got["grads"][k].ravel() for k in want["grads"]])
    g0 = np.concatenate([g.ravel() for g in want["grads"].values()])
    big = np.abs(g0) >= 1e-3 * gmax
    du = np.abs(np.concatenate([got["update"][k].ravel() for k in want["grads"]])
                - np.concatenate([want["update"][k].ravel() for k in want["grads"]]))[big]
    smax = max((np.abs(s).max() for s in want["batch_stats"].values()), default=1.0)
    return {
        "loss_rel": rel(got["metrics"]["loss"], want["metrics"]["loss"]),
        "grad_norm_rel": rel(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"]),
        "grads_rel": float(np.abs(g1 - g0).max() / gmax),
        "grads_cos_gap": 1.0 - float(g1 @ g0 / (np.linalg.norm(g1) * np.linalg.norm(g0))),
        "grads_l2_rel": float(np.linalg.norm(g1 - g0) / np.linalg.norm(g0)),
        "update_rel": float(du.max() / lr),
        "update_flipped": float((du > lr).mean()),
        "stats_rel": max((np.abs(got["batch_stats"][k] - s).max()
                          for k, s in want["batch_stats"].items()), default=0.0) / smax,
    }


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each parameter's gradient gap: max |Δ| over the largest |g| of the
    whole reference gradient."""
    gmax = max(np.abs(g).max() for g in want["grads"].values())
    return {k: float(np.abs(got["grads"][k] - g).max() / gmax) for k, g in want["grads"].items()}


def bf16_pieces(cfg: dict, dev, batch, round_bits=None, fault=None) -> dict:
    """The bf16 train step piece by piece against float32 on the CPU: the
    stem, each MBConv block, the features (head conv, attention, pooling)
    and the classifier with the loss, each fed the float32 model's input
    to it, in train mode. A piece other than the last ends in a seeded
    random probe (the sum of its output times fixed noise). For each
    piece: its output, the gradient of its input and its parameters'
    gradients as the L2 norm of the difference over the reference's, the
    worst of the three. Returns the worst and the median piece of the stem
    and blocks, and the features' and the classifier's. ``round_bits`` and
    ``fault`` act on the bf16 model (the controls)."""
    ref, _, crit = train_setup(cfg, torch.float32, "cpu")
    low, _, crit_low = train_setup(cfg, torch.bfloat16, dev)
    for m in (ref, low):
        m.feature_extractor.backbone.drop_connect_rate = 0.0
        m.train()
    if round_bits is not None:
        round_conv_outputs(low, round_bits)
    if fault is not None:
        fault(low)
    n = len(ref.feature_extractor.backbone.blocks)
    lms, labels = torch.from_numpy(batch["landmarks"]), torch.from_numpy(batch["label"])

    def piece(k, m, x, where):
        bb = m.feature_extractor.backbone
        if k == 0:
            return bb(x, stop_block=0)
        if k <= n:
            return getattr(bb, f"block_{k - 1}")(x.to(bb.dtype))
        if k == n + 1:
            return m.feature_extractor(x, lms.to(where), backbone_start_block=n)
        h = x.to(bb.dtype)
        for i in range(m.n_hidden):
            h = getattr(m, f"head_{i}")(h)
        return (crit if where == "cpu" else crit_low)(m.final(h).float(), labels.to(where),
                                                       x)["total"]

    def gap(a, b):
        return float((a.double().cpu() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(batch["image"])
    errs = []
    for k in range(n + 3):
        runs = []
        for m, where in ((ref, "cpu"), (low, dev)):
            m.zero_grad(set_to_none=True)
            xi = x.to(where).clone().requires_grad_()
            runs.append((xi, piece(k, m, xi, where)))
        (xr, yr), (xl, yl) = runs
        if k <= n + 1:
            probe = torch.randn(yr.shape, generator=g)
            (yr * probe).sum().backward()
            (yl.float() * probe.to(dev)).sum().backward()
        else:
            yr.backward()
            yl.backward()
        named = dict(low.named_parameters())
        pr = [(name, p.grad) for name, p in ref.named_parameters() if p.grad is not None]
        errs.append(max(gap(yl.detach().float(), yr.detach()), gap(xl.grad, xr.grad),
                        gap(torch.cat([named[name].grad.flatten().cpu() for name, _ in pr]),
                            torch.cat([q.flatten() for _, q in pr]))))
        x = yr.detach()
    del ref, low
    return {"blocks_worst": max(errs[:n + 1]), "blocks_median": statistics.median(errs[:n + 1]),
            "features": errs[n + 1], "classifier": errs[n + 2]}


def optimizer_card_vs_cpu(dev, weight_decay: float = 0.1) -> float:
    """The train CLI's optimizer (AdamW, clip 1.0 by global norm) on the
    card against the CPU: three steps on seeded leaves of B4 shapes with
    seeded gradients, lr 1e-2 (at the configuration's lr and weight decay
    of 1e-4 the decay, lr · wd · p, lies below float32's resolution of p).
    Max |Δ| of the parameters over lr."""
    from deepfake_vit_tpu_torch.training import create_optimizer
    from deepfake_vit_tpu_torch.training.optim import clip_and_step

    lr, shapes = 1e-2, [(48, 3, 3, 3), (1792,), (1792, 448), (2, 32)]
    rng = np.random.default_rng(3)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1e-3 * (k + 1), s).astype(np.float32) for s in shapes]
             for k in range(3)]
    out = []
    for where, wd in (("cpu", 0.1), (dev, weight_decay)):
        ps = [torch.nn.Parameter(torch.tensor(p, device=where)) for p in p0]
        opt = create_optimizer(ps, {"type": "AdamW", "lr": lr, "weight_decay": wd},
                               gradient_clip=1.0)
        for g in grads:
            for p, x in zip(ps, g):
                p.grad = torch.tensor(x, device=where)  # a copy: the clip scales it
            clip_and_step(opt, ps)
        out.append([p.detach().double().cpu().numpy() for p in ps])
    return max(np.abs(a - b).max() for a, b in zip(*out)) / lr


def train_profile(step, batch, step_ms: float) -> dict:
    """One train step under torch.profiler: device time by class."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        # "Optimizer.step#AdamW.step" and the like are ranges that span
        # kernels counted on their own: not device work of their own.
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.key.startswith(("Optimizer.", "ProfilerStep"))):
            by_kernel[ev.key] += ev.self_device_time_total
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the train step")
    by_class = defaultdict(float)
    for name, us in by_kernel.items():
        low = name.lower()
        by_class[next((label for label, keys in TRAIN_KERNEL_CLASSES
                       if any(k in low for k in keys)), "other")] += us
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / step_ms,
            "device_ms_by_class": {k: v / 1e3 for k, v in
                                   sorted(by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [(k, v / 1e3) for k, v in
                               sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]]}


def training_phase(kernels, wk, card: str, dev) -> dict:
    """The training path on the card: the warp kernel at the train step's
    shape; one step card vs CPU in float32, in bf16 piece by piece, and
    the optimizer alone; LEARN_STEPS steps
    of the training configuration (bf16, CombinedLoss, AdamW + clip 1.0,
    augmentation on; dropout and drop-connect off) on one batch of 32
    faces with every kernel's launches counted (one warp a step) and the
    loss falling; its checkpoint into DeepfakePredictor; ms a step,
    images/s and peak memory of the full configuration at B = 32 and 64,
    twice in turns; one profiled step."""
    import copy
    import tempfile

    from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG, TRAINING_CONFIG
    from deepfake_vit_tpu_torch.inference import DeepfakePredictor
    from deepfake_vit_tpu_torch.ops.augment import draw_rotation, make_augment_fn
    from deepfake_vit_tpu_torch.ops.augment import rotation_matrices
    from deepfake_vit_tpu_torch.ops.umeyama import invert_affine
    from deepfake_vit_tpu_torch.training import Trainer, create_scheduler, make_eval_step

    res = {}
    # The kernel at the train step's shape: 32 normalized faces, ±5° rotations.
    faces = torch.from_numpy(train_faces(32, 21)["image"]).to(dev)
    theta = draw_rotation(32, 5.0, torch.Generator(device=dev).manual_seed(0), dev)
    A_inv = invert_affine(rotation_matrices(theta, TRAIN_SIZE))
    row = check_warp("warp_affine_legacy", wk.warp_affine_legacy, wk.warp_affine_legacy_plain,
                     faces.to(torch.bfloat16), A_inv, TRAIN_SIZE)
    row.pop("out")
    row["shape"] = "train step: 32 normalized 224² faces, ±5° rotation -> 224²"
    res["warp_row"] = row
    del faces

    # Card vs CPU: one step in float32 without TF32, the bf16 step piece by
    # piece with its controls, the optimizer alone.
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["model"]["feature_extractor"]["dropout_rate"] = 0.0
    cfg["model"]["classifier"]["dropout_rate"] = 0.0
    lr = cfg["training"]["optimizer"]["lr"]
    small = train_faces(4, TRAIN_SEEDS[0])
    t0 = time.time()
    want = one_train_step(cfg, torch.float32, "cpu", small)
    cpu_s = time.time() - t0
    f32 = {}
    for seed in TRAIN_SEEDS:
        batch = small if seed == TRAIN_SEEDS[0] else train_faces(4, seed)
        f64 = one_train_step(cfg, torch.float64, "cpu", batch)
        with tf32_off():
            f32[seed] = compare_steps(one_train_step(cfg, torch.float32, dev, batch), f64, lr)
        if seed == TRAIN_SEEDS[0]:
            cpu_vs_f64 = compare_steps(want, f64, lr)
    f64_s = time.time() - t0 - cpu_s
    whole = compare_steps(one_train_step(cfg, torch.bfloat16, dev, small), want, lr)
    pieces = bf16_pieces(cfg, dev, small)
    controls = {"convolutions at 6 bits": bf16_pieces(cfg, dev, small, round_bits=6),
                "BatchNorm in bf16": bf16_pieces(cfg, dev, small, fault=bn_in_input_dtype)}
    opt_err, opt_control = optimizer_card_vs_cpu(dev), optimizer_card_vs_cpu(dev, 0.0)
    torch.cuda.empty_cache()
    short = lambda d: {k: float(f"{v:.3g}") for k, v in d.items()}  # noqa: E731
    for seed, gaps in f32.items():
        print(f"train step, B4 at 224², batch 4 (seed {seed}), card (float32) vs CPU (float64): "
              f"{short(gaps)} (limits {TRAIN_LIMITS})")
    print(f"train step, seed {TRAIN_SEEDS[0]}, CPU (float32, {cpu_s:.1f} s) vs CPU (float64): "
          f"{short(cpu_vs_f64)}; {len(TRAIN_SEEDS)} float64 steps and card steps {f64_s:.1f} s")
    print(f"train step, bf16 on the card vs float32 on the CPU, whole step (printed, not held): "
          f"{short(whole)}")
    print(f"train step, bf16 piece by piece: {short(pieces)} (limits {BF16_PIECE_LIMITS}); "
          + "; ".join(f"control, {k}: {short(v)}" for k, v in controls.items()))
    print(f"optimizer (AdamW + clip, 3 steps) card vs CPU: {opt_err:.3g} lr (limit "
          f"{OPTIMIZER_LIMIT}); control without weight decay {opt_control:.3g} lr")
    bad = {seed: {k: v[k] for k, lim in TRAIN_LIMITS.items() if not v[k] <= lim}
           for seed, v in f32.items()}
    if any(bad.values()):
        fail(f"the train step on the card (float32) disagrees with float64: {bad}")
    if not all(math.isfinite(v) for v in whole.values()):
        fail(f"the whole bf16 train step on the card is not finite: {whole}")
    over = lambda d: {k: v for k, v in d.items() if not v <= BF16_PIECE_LIMITS[k]}  # noqa: E731
    if over(pieces):
        fail(f"the bf16 train step's pieces on the card disagree with the CPU: {over(pieces)}")
    blind = [k for k, v in controls.items() if not over(v)]
    if blind:
        fail(f"the bf16 limits pass the control(s) {blind}: they cannot see a fault")
    if not (opt_err <= OPTIMIZER_LIMIT < opt_control):
        fail(f"the optimizer on the card: {opt_err} lr from the CPU, control {opt_control} lr")
    res["card_vs_cpu"] = {"float32_vs_float64": f32, "cpu_float32_vs_float64": cpu_vs_f64,
                          "bfloat16_whole_step": whole, "bfloat16_pieces": pieces,
                          "bfloat16_controls": controls, "optimizer_lr": opt_err,
                          "optimizer_control_lr": opt_control}

    # It learns: the training configuration with augmentation on, dropout
    # and drop-connect off (their masks' noise hides a 30-step trend: a b0
    # at 64² on the CPU shows none in 100 steps with them), through the
    # Trainer's step.
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["data"]["augmentation"] = dict(LEARN_AUG)
    cfg["model"]["feature_extractor"]["dropout_rate"] = 0.0
    cfg["model"]["classifier"]["dropout_rate"] = 0.0

    def trainer_for(cfg, seed):  # the train CLI's objects, clip 1.0
        model, opt, crit = train_setup(cfg, torch.bfloat16, dev, seed=seed)
        lr = cfg["training"]["optimizer"]["lr"]
        return Trainer(model, opt, crit, [], [], create_scheduler(cfg["training"]["scheduler"], lr),
                       augment_fn=make_augment_fn(cfg["data"]["augmentation"]), seed=5)

    trainer = trainer_for(cfg, 1)
    trainer.model.feature_extractor.backbone.drop_connect_rate = 0.0
    batch = train_faces(BATCH, 23)
    for k in kernels:
        k.launches = 0
    losses = [float(trainer.train_step(trainer.state, batch, trainer.seed)["loss"])
              for _ in range(LEARN_STEPS)]
    launches = {k.__name__: k.launches for k in kernels}
    expected = {**dict.fromkeys(KERNEL_NAMES, 0), "warp_affine_legacy": LEARN_STEPS}
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"[{card}] training, B4 at 224², batch {BATCH}, bf16, CombinedLoss, AdamW + clip, "
          f"augmentation on: loss over {LEARN_STEPS} steps {[round(v, 4) for v in losses]}; "
          f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}; launches {launches}")
    if launches != expected:
        fail(f"training: launches {launches}, expected {expected}")
    if not (all(math.isfinite(v) for v in losses) and last < first):
        fail(f"training: the loss did not fall ({first} -> {last})")
    res.update(learn_losses=losses, learn_launches=launches)

    # The checkpoint into the predictor.
    with tempfile.TemporaryDirectory() as tmp:
        trainer.config["save_dir"] = tmp
        path = trainer.save_checkpoint(0, is_best=True)
        pred = DeepfakePredictor({"model": cfg["model"]}, PREPROCESSING_CONFIG,
                                 checkpoint_path=str(Path(tmp) / "best_model.ckpt"), device=dev)
        ckpt_mb = path.stat().st_size / 2 ** 20
    ev = make_eval_step(trainer.model, trainer.criterion)(batch)
    x = torch.from_numpy(batch["image"]).to(dev)
    lms = torch.from_numpy(batch["landmarks"]).to(dev)
    fake, _ = pred._predict(x, lms, torch.ones(BATCH, device=dev))
    pred_err = (fake.float() - ev["probs"][:, 1].float()).abs().max().item()
    served = pred.predict_frames(list(clip_frames(PREDICTOR_CLIPS["640x640"])[:8]))
    print(f"checkpoint ({ckpt_mb:.1f} MiB) -> DeepfakePredictor on the card: fake probabilities "
          f"of the {BATCH} training faces within {pred_err:.2e} of the trainer's eval step "
          f"(limit 1e-3); 8 frames of the 640² clip served: {served['num_faces']} faces, "
          f"fake_prob {served['fake_prob']:.4f}")
    if not pred_err <= 1e-3:
        fail(f"the predictor's probabilities differ from the trainer's by {pred_err}")
    if served["num_faces"] < 1 or not math.isfinite(served["fake_prob"]):
        fail(f"the predictor did not serve the frames: {served}")
    res.update(predictor_prob_err=pred_err, checkpoint_mib=ckpt_mb)
    del pred, trainer
    torch.cuda.empty_cache()

    # ms a step, images/s and peak memory at B = 32 and 64, twice in turns:
    # the full configuration (dropout 0.4, drop-connect 0.2, augmentation).
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["data"]["augmentation"] = dict(LEARN_AUG)
    trainer = trainer_for(cfg, 2)
    batches = {b: train_faces(b, 30 + b) for b in TRAIN_BATCHES}

    def step(b):
        return trainer.train_step(trainer.state, b, trainer.seed)

    rounds = []
    for rnd in range(2):
        for bsz in TRAIN_BATCHES:
            step(batches[bsz])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                step(batches[bsz])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if wk.warp_affine_legacy.launches != TIMED_STEPS:
                fail(f"training, B = {bsz}: {wk.warp_affine_legacy.launches} warp launches in "
                     f"{TIMED_STEPS} steps")
            rounds.append({"round": rnd, "batch": bsz, "ms_per_step": ms,
                           "images_per_s": bsz * 1e3 / ms, "peak_memory_gib": peak})
            print(f"[{card}] training round {rnd}, B = {bsz}: {ms:.2f} ms a step, "
                  f"{bsz * 1e3 / ms:.1f} images/s ({TIMED_STEPS} steps after one warm-up), "
                  f"peak memory {peak:.2f} GiB")
    res["rounds"] = rounds
    step_ms = statistics.median(r["ms_per_step"] for r in rounds if r["batch"] == BATCH)
    prof = train_profile(lambda b: step(b), batches[BATCH], step_ms)
    print(f"    profiled step, B = {BATCH}: device busy {prof['device_busy_ms']:.2f} ms of "
          f"{step_ms:.2f} ms a step (the timed median), idle share "
          f"{prof['device_idle_share']:.3f}; the profiled step took {prof['profiled_wall_ms']:.2f} "
          f"ms on the host's clock")
    if prof["device_idle_share"] < 0:
        print("    the profiled step's device time exceeds the timed median step: the idle share "
              "is not measured in this run")
    for label, ms in prof["device_ms_by_class"].items():
        print(f"    {label:38s} {ms:8.3f} ms")
    for name, ms in prof["top_kernels_ms"][:6]:
        print(f"    {ms:8.3f} ms  {name[:100]}")
    res["profile"] = prof
    del trainer
    torch.cuda.empty_cache()
    return res


# The detector families, detector training and the loaders (phase 4c-4f).
H_PATH = "H mtcnn detector"
H_FACES = (36, 110)  # MTCNN-Lite's training faces (px), drawn into 640² frames
H_SCENES = 32
# The predictor's new families: overrides of PREPROCESSING_CONFIG["detection"]
# (HOG at its class default canvas, 320²; the others at the config's 640²).
DETECTOR_FAMILIES = {"mtcnn": {"model": "mtcnn"},
                     "hog": {"model": "hog", "scrfd": {"input_size": [320, 320]}},
                     "scrfd + refine": {"refine": True}}
# Detector training at the CLI's defaults: 320² scenes, B = 32, 8 faces at
# most, AdamW lr 1e-3, clip 5.0, float32.
DT_SIZE, DT_BATCH, DT_MAX_FACES, DT_LR, DT_SCENES, DT_STEPS = 320, 32, 8, 1e-3, 64, 20
HOG_FIT_SCENES = 100  # fit_hog_template's scenes (the CLI default is 400)
# The loaders feeding T: drawn 224² faces written as PNGs, the train step
# of T (augmentation on) at B = 32, each loader timed over LOADER_STEPS
# steps after LOADER_WARMUP, in turns (host, device, cached, then back).
LOADER_FACES, LOADER_STEPS, LOADER_WARMUP = 1024, 8, 2


def h_frames(n: int, seed: int) -> np.ndarray:
    """n 640² drawn scenes (``data/synth_faces.py::render_scene``) with 1-3
    faces of H_FACES px each."""
    from deepfake_vit_tpu_torch.data.synth_faces import render_scene

    rng = np.random.default_rng(seed)
    return np.stack([render_scene(rng, size=SERVING[0], max_faces=3, min_face=H_FACES[0],
                                  max_face=H_FACES[1], p_empty=0.0)[0] for _ in range(n)])


def tiled_batches(frames: np.ndarray, batch: int, n: int):
    """n batches of ``batch`` frames cycling through ``frames``."""
    idx = np.arange(batch * n) % len(frames)
    return [torch.from_numpy(frames[idx[i * batch:(i + 1) * batch]]) for i in range(n)]


def h_faces_on_cpu(frames: np.ndarray) -> np.ndarray:
    """Per frame: does the MTCNN-Lite detector (640² canvas, threshold 0.5)
    find a face, on the CPU."""
    from deepfake_vit_tpu_torch.preprocessing.detector import FaceDetector

    det = FaceDetector(model_name="mtcnn", input_size=SERVING, device="cpu")
    return np.asarray([d is not None for d in det.batch_detect(list(frames))])


def detector_step(model_name: str, dtype, where, batch) -> dict:
    """One train step of ``model_name`` (seeded, the CLI's optimizer) in
    ``dtype`` on ``where``: the metrics, gradients, updates and running
    statistics in ``compare_steps``' layout."""
    from deepfake_vit_tpu_torch.models.bridge import export_flax_variables
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.preprocessing.detector import build_detection_net
    from deepfake_vit_tpu_torch.training import create_optimizer
    from deepfake_vit_tpu_torch.training.detection import make_detector_train_step

    model = init_weights(build_detection_net(model_name, dtype=dtype), 0)
    model = (model.double() if dtype == torch.float64 else model).to(where)
    p0 = {n: p.detach().to("cpu", torch.float64, copy=True) for n, p in model.named_parameters()}
    opt = create_optimizer(model.parameters(), {"type": "AdamW", "lr": DT_LR}, gradient_clip=5.0)
    losses = make_detector_train_step(model, opt, (DT_SIZE, DT_SIZE))(batch)
    return {"metrics": {"loss": float(losses["total"]), "grad_norm": float(losses["grad_norm"])},
            "grads": {n: p.grad.double().cpu().numpy() for n, p in model.named_parameters()},
            "update": {n: (p.detach().double().cpu() - p0[n]).numpy()
                       for n, p in model.named_parameters()},
            "batch_stats": flat_tree(export_flax_variables(model)["batch_stats"])}


def detector_training_phase(kernels, card: str, dev) -> dict:
    """Detector training on the card at the CLI's defaults, on drawn
    scenes written by ``write_corpus``: one SCRFD step held to a float64
    step on the CPU (the CPU's float32 step printed beside it); DT_STEPS
    steps each of scrfd, mtcnn and refine with the loss falling, ms a
    step, images/s and peak memory; one ``fit_hog_template`` of
    HOG_FIT_SCENES scenes held to the HOG bar."""
    import tempfile

    from deepfake_vit_tpu_torch.data.synth_faces import write_corpus
    from deepfake_vit_tpu_torch.models.hog_detector import HogFaceDetector, fit_hog_template
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.models.refine_net import RefineNet
    from deepfake_vit_tpu_torch.preprocessing.detector import build_detection_net
    from deepfake_vit_tpu_torch.train_detector import load_annotations, make_batch
    from deepfake_vit_tpu_torch.training import create_optimizer
    from deepfake_vit_tpu_torch.training.detection import make_detector_train_step
    from deepfake_vit_tpu_torch.training.refinement import (make_refiner_train_step,
                                                            sample_refine_targets)

    res = {}
    rng = np.random.default_rng(42)
    with tempfile.TemporaryDirectory() as tmp:
        records = load_annotations(write_corpus(tmp, DT_SCENES, size=DT_SIZE, seed=42,
                                                max_faces=DT_MAX_FACES))
        batches = [make_batch(records, order[i:i + DT_BATCH], DT_SIZE, DT_MAX_FACES)
                   for order in (rng.permutation(DT_SCENES),)
                   for i in range(0, DT_SCENES, DT_BATCH)]
    t0 = time.time()
    f64 = detector_step("scrfd", torch.float64, "cpu", batches[0])
    cpu32 = detector_step("scrfd", torch.float32, "cpu", batches[0])
    with tf32_off():
        card32 = detector_step("scrfd", torch.float32, dev, batches[0])
    gaps = {"card float32": compare_steps(card32, f64, DT_LR),
            "CPU float32": compare_steps(cpu32, f64, DT_LR),
            "card vs CPU, float32": compare_steps(card32, cpu32, DT_LR)}
    leaves = leaf_gaps(card32, f64)
    worst = sorted(leaves, key=leaves.get, reverse=True)[:3]
    short = lambda d: {k: float(f"{v:.3g}") for k, v in d.items()}  # noqa: E731
    for k, v in gaps.items():
        print(f"detector step, scrfd {DT_SIZE}², batch {DT_BATCH}, {k} vs float64 on the CPU "
              f"({time.time() - t0:.1f} s): {short(v)}")
    print(f"detector step, the card's leaves farthest from float64: "
          f"{[(k, round(leaves[k], 7)) for k in worst]} (limits {TRAIN_LIMITS})")
    bad = {k: gaps["card float32"][k] for k, lim in TRAIN_LIMITS.items()
           if not gaps["card float32"][k] <= lim}
    if bad:
        fail(f"the SCRFD train step on the card disagrees with float64: {bad}")
    res["scrfd_step_vs_float64"] = gaps
    res["families"] = {}
    for name in ("scrfd", "mtcnn", "refine"):
        torch.cuda.reset_peak_memory_stats()
        model = init_weights(RefineNet() if name == "refine" else build_detection_net(name), 0)
        model = model.to(dev)
        opt = create_optimizer(model.parameters(), {"type": "AdamW", "lr": DT_LR},
                               gradient_clip=5.0)
        step = (make_refiner_train_step(model, opt) if name == "refine"
                else make_detector_train_step(model, opt, (DT_SIZE, DT_SIZE)))
        sampler = np.random.default_rng(7)
        feed = [sample_refine_targets(b, sampler) if name == "refine" else b
                for b in batches * (DT_STEPS // len(batches))]
        for k in kernels:
            k.launches = 0
        losses, t_start = [], None
        for i, batch in enumerate(feed):
            if i == 5:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            losses.append(float(step(batch)["total"]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3 / (len(feed) - 5)
        launches = {k.__name__: k.launches for k in kernels if k.launches}
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{card}] detector training, {name}, {DT_SIZE}² scenes, batch {DT_BATCH}, "
              f"float32: loss over {len(feed)} steps {[round(v, 4) for v in losses]}; mean of "
              f"the first 5 {first:.4f}, of the last 5 {last:.4f}; {ms:.2f} ms a step "
              f"({DT_BATCH * 1e3 / ms:.1f} images/s, host clock over {len(feed) - 5} steps), "
              f"peak memory {peak:.2f} GiB; kernel launches {launches}")
        if not (all(math.isfinite(v) for v in losses) and last < first):
            fail(f"detector training, {name}: the loss did not fall ({first} -> {last})")
        res["families"][name] = {"losses": losses, "ms_per_step": ms,
                                 "images_per_s": DT_BATCH * 1e3 / ms, "peak_gib": peak}
        del model, opt, step
    t0 = time.time()
    params = fit_hog_template(n_scenes=HOG_FIT_SCENES, scene_size=DT_SIZE, seed=42, device=dev)
    fit_s = time.time() - t0
    from deepfake_vit_tpu_torch.acceptance import hog_bar

    bar = hog_bar(HogFaceDetector(input_size=(DT_SIZE, DT_SIZE), params=params, device=dev))
    print(f"[{card}] fit_hog_template on {HOG_FIT_SCENES} scenes: {fit_s:.1f} s; its HOG bar: "
          f"{bar}")
    if not bar["held"]:
        fail(f"the HOG template fitted on {HOG_FIT_SCENES} scenes misses the HOG bar: {bar}")
    res["hog_fit"] = {"scenes": HOG_FIT_SCENES, "seconds": fit_s, **bar}
    torch.cuda.empty_cache()
    return res


def loader_phase(kernels, card: str, dev) -> dict:
    """The train step of T (B4 at 224², bf16, augmentation on, B = 32) fed
    by HostLoader, DeviceLoader and CachedDeviceLoader over LOADER_FACES
    drawn faces written as PNGs with cv2: the loaders' first batches held
    equal, then ms a step of each, in turns (host, device, cached, cached,
    device, host), one warp launch a step."""
    import copy
    import tempfile

    from deepfake_vit_tpu_torch.configs import TRAINING_CONFIG
    from deepfake_vit_tpu_torch.data.dataset import (CachedDeviceLoader, DeviceLoader, HostLoader,
                                                     PreprocessedFaceDataset)
    from deepfake_vit_tpu_torch.ops.augment import make_augment_fn
    from deepfake_vit_tpu_torch.tools.synth_processed import write_processed
    from deepfake_vit_tpu_torch.training import TrainState, make_train_step

    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["data"]["augmentation"] = dict(LEARN_AUG)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        write_processed(Path(tmp), (LOADER_FACES, 0, 0), size=TRAIN_SIZE[0], seed=0)
        write_s = time.time() - t0
        ds = PreprocessedFaceDataset(Path(tmp) / "splits" / "train.csv", tmp,
                                     image_size=TRAIN_SIZE[0])
        common = dict(batch_size=BATCH, shuffle=True, drop_last=True, num_workers=8, seed=0)
        loaders = {"HostLoader": HostLoader(ds, **common),
                   "DeviceLoader": DeviceLoader(HostLoader(ds, **common), dev),
                   "CachedDeviceLoader": CachedDeviceLoader(ds, device=dev, **common)}
        t0 = time.time()
        first = {name: next(iter(loader)) for name, loader in loaders.items()}  # stages the cache
        stage_s = time.time() - t0
        want = first["HostLoader"]
        for name, batch in first.items():
            for k in ("image", "label", "landmarks", "quality_score"):
                got = batch[k].cpu().numpy() if isinstance(batch[k], torch.Tensor) else batch[k]
                if not np.array_equal(got, np.asarray(want[k]).astype(got.dtype)):
                    fail(f"loaders: {name}'s first batch differs from HostLoader's in {k}")
        model, opt, crit = train_setup(cfg, torch.bfloat16, dev)
        step = make_train_step(model, crit, opt, augment_fn=make_augment_fn(LEARN_AUG))
        state = TrainState()
        for rnd, order in enumerate((list(loaders), list(loaders)[::-1])):
            for name in order:
                loader = loaders[name]
                loader.set_epoch(rnd)
                it = iter(loader)
                for _ in range(LOADER_WARMUP):
                    step(state, next(it), 0)
                torch.cuda.synchronize()
                for k in kernels:
                    k.launches = 0
                t0 = time.perf_counter()
                for _ in range(LOADER_STEPS):
                    step(state, next(it), 0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / LOADER_STEPS
                it.close()
                launches = {k.__name__: k.launches for k in kernels if k.launches}
                if launches != {"warp_affine_legacy": LOADER_STEPS}:
                    fail(f"loaders, {name}: launches {launches}, expected one warp a step")
                print(f"[{card}] round {rnd}, T's train step fed by {name}: {ms:.2f} ms a step "
                      f"({BATCH * 1e3 / ms:.1f} images/s, host clock over {LOADER_STEPS} steps "
                      f"after {LOADER_WARMUP}); launches {launches}")
                res.setdefault(name, []).append(ms)
    print(f"loaders: {LOADER_FACES} PNG faces written in {write_s:.1f} s; first batches (the "
          f"cache's staging included) {stage_s:.1f} s; batches equal")
    del model, opt
    torch.cuda.empty_cache()
    return {"ms_per_step": res, "write_s": write_s, "stage_s": stage_s}


# The ViT fallback family: path I, the HOG + ViT predictor, the
# ViT train step.
VIT_CONFIG = {"patch": 16, "width": 768, "depth": 12, "mlp": 3072}
# Kernel-name fragments → class for path I's profile, first match wins:
# cuDNN's convolutions (the detector, the patch embedding) before the
# GEMMs, whose Hopper kernels carry "xmma"/"nvjet"/"gemm" in their names.
VIT_KERNEL_CLASSES = (
    ("host <-> device copy", ("memcpy",)),
    ("crop_pool (port kernel)", ("crop_pool_band_kernel",)),
    ("warp_affine_legacy (port kernel)", ("warp_tile_kernel<0>",)),
    ("convolution (detector, patch embedding)", ("conv", "cudnn", "implicit", "winograd",
                                                 "fprop", "nhwc", "nchw")),
    ("GEMM (QKV, QKᵀ, weights·V, projections, MLP)", ("gemm", "nvjet", "cutlass", "xmma",
                                                       "sm90", "sm80", "cublas")),
    ("attention softmax", ("softmax",)),
    ("GELU", ("gelu",)),
    ("reduction (LayerNorm statistics among them)", ("reduce", "mean", "sum", "max", "norm")),
    ("copy / layout", ("copy", "cat", "transpose", "permute", "fill", "index", "gather",
                       "scatter")),
)
VIT_TRAIN_BATCH = 4  # the float32 step against float64 (one batch of TRAIN_SEEDS)


def vit_flops(batch: int, image: int = 224, classes: int = 2) -> float:
    """The ViT-B/16 forward's operations (2 per multiply-add): the patch
    embedding, per block the QKV projection, QKᵀ and weights·V over all
    heads, the output projection and the two MLP products, the head."""
    P, W, depth, mlp = (VIT_CONFIG[k] for k in ("patch", "width", "depth", "mlp"))
    n = (image // P) ** 2
    L = n + 1
    block = L * W * 3 * W + 2 * L * L * W + L * W * W + 2 * L * W * mlp
    return 2.0 * batch * (n * P * P * 3 * W + depth * block + W * classes)


def vit_ranges(pipe) -> dict:
    """Path I's named modules for the profile: the detector, the whole ViT,
    every LayerNorm, every attention (QKV projection to output projection)
    and every MLP product (fc1, fc2; the GELU between them is classed by
    its kernel's name)."""
    from deepfake_vit_tpu_torch.models.layers import LayerNorm, MultiHeadDotProductAttention
    from deepfake_vit_tpu_torch.models.vit import EncoderBlock

    named = {pipe.detector: "detector", pipe.model: "ViT-B/16 forward"}
    for m in pipe.model.modules():
        if isinstance(m, LayerNorm):
            named[m] = "LayerNorm"
        elif isinstance(m, MultiHeadDotProductAttention):
            named[m] = "attention"
        elif isinstance(m, EncoderBlock):
            named[m.fc1] = named[m.fc2] = "MLP products (fc1, fc2)"
    return named


def trace_names_warp(pipe, frames) -> dict:
    """One batch under ``utils/profiling.trace``: the Chrome trace must name
    the warp kernel."""
    import tempfile

    from deepfake_vit_tpu_torch.utils.profiling import annotate, trace

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            with annotate("path I batch"):
                pipe.forward(frames)
        text = (Path(tmp) / "trace.json").read_text()
    found = {k: k in text for k in ("warp_tile_kernel", "crop_pool_band_kernel", "path I batch")}
    print(f"path {I_PATH}: utils/profiling.trace of one batch: {len(text) / 2 ** 20:.1f} MiB of "
          f"Chrome trace, names {found}")
    if not all(found.values()):
        fail(f"the trace of path I does not name {[k for k, v in found.items() if not v]}")
    return {"trace_mib": len(text) / 2 ** 20, **found}


def vit_predictor_phase(kernels, dev) -> dict:
    """The reference's fallback stack on the card: ``detection.model: hog``
    + ViT-B/16 (seeded, the predictor's seed 0). The 5-frame 1280×720 clip
    in float32 card vs CPU (num_faces equal, fake_prob within
    PREDICTOR_PROB_TOL); both clips in bf16 with one warp launch a clip
    and ms a clip on the host clock."""
    from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
    from deepfake_vit_tpu_torch.inference import DeepfakePredictor
    from deepfake_vit_tpu_torch.models.vit import ViTClassifier

    config = {**PREPROCESSING_CONFIG,
              "detection": {**PREPROCESSING_CONFIG["detection"], **DETECTOR_FAMILIES["hog"]}}
    cfg = {"model": VIT_MODEL}
    tag = "predictor (hog detector, ViT-B/16)"
    clips = {name: clip_frames(spec) for name, spec in PREDICTOR_CLIPS.items()}
    res = {}
    with tf32_off():
        card32 = DeepfakePredictor(cfg, config, dtype=torch.float32, device=dev)
        cpu32 = DeepfakePredictor(cfg, config, dtype=torch.float32, device="cpu")
        frames = list(clips["1280x720"])
        got, want = card32.predict_frames(frames), cpu32.predict_frames(frames)
    err = abs(got["fake_prob"] - want["fake_prob"])
    print(f"{tag}, 1280x720 clip of {len(frames)} frames: card vs CPU, float32: num_faces "
          f"{got['num_faces']} / {want['num_faces']}, fake_prob {got['fake_prob']:.5f} / "
          f"{want['fake_prob']:.5f} (|diff| {err:.5f}, limit {PREDICTOR_PROB_TOL})")
    if not isinstance(card32.model, ViTClassifier):
        fail(f"{tag}: the predictor built {type(card32.model).__name__}")
    if got["num_faces"] != want["num_faces"] or got["num_faces"] == 0:
        fail(f"{tag}: num_faces {got['num_faces']} on the card, {want['num_faces']} on the CPU")
    if not err <= PREDICTOR_PROB_TOL:
        fail(f"{tag}: fake_prob differs by {err} between card and CPU")
    res["card_vs_cpu_fake_prob_err"] = err
    del card32, cpu32

    pred = DeepfakePredictor(cfg, config, device=dev)  # bf16
    for name, frames in clips.items():
        listed = list(frames)
        pred.predict_frames(listed)  # warm-up
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        out = pred.predict_frames(listed)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        want = {**dict.fromkeys(KERNEL_NAMES, 0), "warp_affine_legacy": 1}
        if launches != want:
            fail(f"{tag}, {name} clip: launches {launches}, expected {want}")
        if not (out["num_faces"] > 0 and all(math.isfinite(p) for p in out["frame_probs"])):
            fail(f"{tag}, {name} clip: {out['num_faces']} faces, probabilities "
                 f"{out['frame_probs']}")
        t0 = time.perf_counter()
        for _ in range(PREDICTOR_REPEATS):
            pred.predict_frames(listed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PREDICTOR_REPEATS
        print(f"{tag} (bf16, seeded), {name} clip of {len(frames)} frames: {ms:.2f} ms a clip on "
              f"the host clock ({PREDICTOR_REPEATS} clips after one warm-up), "
              f"{out['num_faces']} faces, fake_prob {out['fake_prob']:.5f}; launches a clip "
              f"{launches}")
        res[name] = {"frames": len(frames), "ms_per_clip": ms, "launches_per_clip": launches,
                     "num_faces": out["num_faces"], "fake_prob": out["fake_prob"]}
    del pred
    torch.cuda.empty_cache()
    return res


def vit_training_phase(kernels, card: str, dev, t_rounds: list) -> dict:
    """The ViT-B/16 train step: one AdamW step at 224², batch 4, on the card
    in float32 without TF32 against a float64 step on the CPU (one batch of
    TRAIN_SEEDS, within TRAIN_LIMITS); then ms a step, images/s and peak
    memory in bf16 at B = 32 (CombinedLoss, AdamW + clip 1.0, augmentation
    on, one warp launch a step), twice in turns, beside T's B = 32 step of
    the same call."""
    import copy

    from deepfake_vit_tpu_torch.configs import TRAINING_CONFIG
    from deepfake_vit_tpu_torch.ops.augment import make_augment_fn
    from deepfake_vit_tpu_torch.training import Trainer, create_scheduler

    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["model"] = copy.deepcopy(VIT_MODEL)
    lr = cfg["training"]["optimizer"]["lr"]
    batch = train_faces(VIT_TRAIN_BATCH, TRAIN_SEEDS[0])
    t0 = time.time()
    f64 = one_train_step(cfg, torch.float64, "cpu", batch)
    f64_s = time.time() - t0
    with tf32_off():
        gaps = compare_steps(one_train_step(cfg, torch.float32, dev, batch), f64, lr)
    short = {k: float(f"{v:.3g}") for k, v in gaps.items()}
    print(f"ViT train step, ViT-B/16 at 224², batch {VIT_TRAIN_BATCH} (seed {TRAIN_SEEDS[0]}), "
          f"card (float32) vs CPU (float64, {f64_s:.1f} s): {short} (limits {TRAIN_LIMITS})")
    bad = {k: gaps[k] for k, lim in TRAIN_LIMITS.items() if not gaps[k] <= lim}
    if bad:
        fail(f"the ViT train step on the card (float32) disagrees with float64: {bad}")
    del f64
    torch.cuda.empty_cache()

    cfg["data"]["augmentation"] = dict(LEARN_AUG)
    model, opt, crit = train_setup(cfg, torch.bfloat16, dev, seed=2)
    trainer = Trainer(model, opt, crit, [], [], create_scheduler(cfg["training"]["scheduler"], lr),
                      augment_fn=make_augment_fn(cfg["data"]["augmentation"]), seed=5)
    faces = train_faces(BATCH, 30 + BATCH)
    rounds = []
    for rnd in range(2):
        trainer.train_step(trainer.state, faces, trainer.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        losses = [trainer.train_step(trainer.state, faces, trainer.seed)["loss"]
                  for _ in range(TIMED_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {k.__name__: k.launches for k in kernels}
        if launches != {**dict.fromkeys(KERNEL_NAMES, 0), "warp_affine_legacy": TIMED_STEPS}:
            fail(f"ViT training: launches {launches} in {TIMED_STEPS} steps")
        if not all(math.isfinite(float(v)) for v in losses):
            fail(f"ViT training: the loss is not finite: {losses}")
        rounds.append({"round": rnd, "batch": BATCH, "ms_per_step": ms,
                       "images_per_s": BATCH * 1e3 / ms, "peak_memory_gib": peak})
        print(f"[{card}] ViT-B/16 training round {rnd}, B = {BATCH}, bf16: {ms:.2f} ms a step, "
              f"{BATCH * 1e3 / ms:.1f} images/s ({TIMED_STEPS} steps after one warm-up), peak "
              f"memory {peak:.2f} GiB; one warp launch a step")
    t_ms = [r["ms_per_step"] for r in t_rounds if r["batch"] == BATCH]
    print(f"    beside T (B4, B = {BATCH}, same call): {[round(v, 2) for v in t_ms]} ms a step")
    del trainer, model, opt
    torch.cuda.empty_cache()
    return {"float32_vs_float64": gaps, "float64_cpu_s": f64_s, "rounds": rounds,
            "t_ms_per_step": t_ms}


# Data parallelism, sharded serving, the sharded checkpoint and the three
# CLIs (phases 4i-4l). The machine has one card: two ranks (gloo) or two
# replicas share it, so these phases check semantics, and their times are
# context for one card, never a multi-card figure.
DP_BATCH = 32  # global rows of the data-parallel step, DP_BATCH / 2 a rank
DP_ACCUMULATION = (1, 2)
SS_BATCH = 128
SS_LIMITS = {"confidence": 0.02, "bbox": 0.5, "landmarks": 0.5, "quality": 0.02, "probs": 0.02}
CLI_PROB_TOL = 0.02  # fake_prob, card vs CPU (PREDICTOR_PROB_TOL's class)


def dp_step(cfg, dtype, dev, batch, A, init, mesh=None, timed=False) -> dict:
    """One step of the training configuration (augmentation on, dropout
    and drop-connect at their rates, AdamW + clip 1.0) through
    ``make_train_step`` from the parameters ``init``: the metrics and a
    digest of the parameters after it; untimed, also the clipped
    gradients, each parameter's update and the running statistics (as
    ``one_train_step``); ``timed``, the ms of a second step instead."""
    from deepfake_vit_tpu_torch.models.bridge import export_flax_variables
    from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
    from deepfake_vit_tpu_torch.ops.augment import make_augment_fn
    from deepfake_vit_tpu_torch.training import (TrainState, create_optimizer, make_criterion,
                                                 make_train_step)

    # train_setup's model, optimizer and criterion, from ``init``.
    model = create_model_from_config(cfg["model"], dtype=dtype)
    model.load_state_dict(init)
    model.to(dev)
    opt = create_optimizer(model.parameters(), cfg["training"]["optimizer"], gradient_clip=1.0)
    crit = make_criterion(cfg["training"]["loss"], torch.ones(2))
    p0 = {n: p.detach().to("cpu", torch.float64, copy=True) for n, p in model.named_parameters()}
    step = make_train_step(model, crit, opt, accumulation_steps=A, mesh=mesh,
                           augment_fn=make_augment_fn(LEARN_AUG))
    metrics = step(TrainState(), batch, 0)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    if not timed:
        out.update(
            grads={n: p.grad.double().cpu().numpy() for n, p in model.named_parameters()},
            update={n: (p.detach().double().cpu() - p0[n]).numpy()
                    for n, p in model.named_parameters()},
            batch_stats=flat_tree(export_flax_variables(model)["batch_stats"]))
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    out["digest"] = digest.hexdigest()
    if timed:
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        state = TrainState(step=1)
        sync()
        t0 = time.perf_counter()
        step(state, batch, 0)
        sync()
        out["ms"] = (time.perf_counter() - t0) * 1e3
    del model, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dp_worker(rank: int, port: int, work: str, cfg: dict, device: str) -> None:
    """Rank ``rank`` of two on ``device`` over gloo: the float32 steps at
    each accumulation, the local-statistics control, the bf16 steps
    (timed); then rank r runs the one-process reference on the whole batch
    at the r-th accumulation, and rank 0 writes the gaps to
    ``{work}/dp.json``."""
    import torch.distributed as dist

    import deepfake_vit_tpu_torch.models.layers as layers
    from deepfake_vit_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    maybe_initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    dev = torch.device(device)
    mesh = make_mesh(devices=[dev])
    init = torch.load(Path(work) / "init.pt")
    data = dict(np.load(Path(work) / "batch.npz"))
    half = len(data["label"]) // 2
    stripe = {k: v[rank * half:(rank + 1) * half] for k, v in data.items()}
    lr = cfg["training"]["optimizer"]["lr"]
    control = "control: local BatchNorm statistics, A = 1"
    res, runs, seconds = {"ranks_equal": {}}, {}, {}

    def run(name, *args, **kwargs):
        t0 = time.time()
        runs[name] = dp_step(cfg, *args, **kwargs)
        seconds[name] = time.time() - t0

    with tf32_off():
        for A in DP_ACCUMULATION:
            run(f"float32, A = {A}", torch.float32, dev, stripe, A, init, mesh)
        saved = layers.all_reduce_sum
        layers.all_reduce_sum = lambda t, group=None: t  # BatchNorm on the rank's rows
        try:
            run(control, torch.float32, dev, stripe, 1, init, mesh)
        finally:
            layers.all_reduce_sum = saved
    for A in DP_ACCUMULATION:
        run(f"bf16, A = {A}", torch.bfloat16, dev, stripe, A, init, mesh, timed=True)
    for name, r in runs.items():
        digests = [None, None]
        dist.all_gather_object(digests, r["digest"])
        res["ranks_equal"][name] = digests[0] == digests[1]
    res["bf16_ms"] = {name: r["ms"] for name, r in runs.items() if "ms" in r}
    res["bf16_loss"] = {name: r["metrics"]["loss"] for name, r in runs.items()
                        if name.startswith("bf16")}
    # The references, one accumulation a rank, side by side on the card.
    A = DP_ACCUMULATION[rank]
    t0 = time.time()
    with tf32_off():
        want = dp_step(cfg, torch.float32, dev, data, A, init)
    gaps = {f"float32, A = {A}": compare_steps(runs[f"float32, A = {A}"], want, lr)}
    if A == 1:
        gaps[control] = compare_steps(runs[control], want, lr)
    seconds[f"one-process reference, A = {A}"] = time.time() - t0
    parts = [None, None]
    dist.all_gather_object(parts, (gaps, seconds))
    if rank == 0:
        res["gaps"] = {**parts[0][0], **parts[1][0]}
        res["seconds"] = {f"rank {r}: {k}": v for r, (_, sec) in enumerate(parts)
                          for k, v in sec.items()}
        (Path(work) / "dp.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def data_parallel_phase(card: str, dev, cfg: Optional[dict] = None) -> dict:
    """Two ranks (``torch.multiprocessing``, spawn) on the one card over
    gloo: the training configuration's B4 at 224² with augmentation on, a
    global batch of DP_BATCH drawn faces (half a rank), held to the
    one-process step on the same rows within TRAIN_LIMITS at each
    accumulation in float32; the local-statistics control must break the
    limits; one bf16 step of each, timed (two ranks on one card)."""
    import copy
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from deepfake_vit_tpu_torch.configs import TRAINING_CONFIG

    t0 = time.time()
    cfg = cfg or copy.deepcopy(TRAINING_CONFIG)
    with tempfile.TemporaryDirectory() as work:
        model, _, _ = train_setup(cfg, torch.float32, "cpu")
        torch.save(model.state_dict(), Path(work) / "init.pt")
        del model
        np.savez(Path(work) / "batch.npz", **train_faces(DP_BATCH, 41))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(dp_worker, args=(port, work, cfg, str(dev)), nprocs=2, join=True,
                           start_method="spawn")
        res = json.loads((Path(work) / "dp.json").read_text())
    res["wall_s"] = time.time() - t0
    for name, gap in res["gaps"].items():
        within = all(gap[k] <= TRAIN_LIMITS[k] for k in TRAIN_LIMITS)
        print(f"[{card}] data-parallel step, two ranks on one card (gloo), B = {DP_BATCH} "
              f"({DP_BATCH // 2} a rank), {name}: against one process on the same rows "
              f"{ {k: float(f'{v:.3g}') for k, v in gap.items()} } (limits {TRAIN_LIMITS}); "
              f"{'within' if within else 'beyond'} the limits; ranks bit for bit equal: "
              f"{res['ranks_equal'][name]}")
        if name.startswith("control"):
            if within:
                fail(f"data-parallel control ({name}) stays within TRAIN_LIMITS: {gap}")
        elif not within or not res["ranks_equal"][name]:
            fail(f"data-parallel step ({name}) breaks TRAIN_LIMITS or the ranks differ: {gap}")
    for name, ms in res["bf16_ms"].items():
        print(f"[{card}] data-parallel {name} step, two ranks on one card (context, not a "
              f"multi-card figure): {ms:.1f} ms on rank 0, loss {res['bf16_loss'][name]:.4f}")
        if not res["ranks_equal"][name] or not math.isfinite(res["bf16_loss"][name]):
            fail(f"data-parallel {name}: ranks differ or the loss is not finite")
    print(f"data-parallel phase: {res['wall_s']:.1f} s; seconds "
          f"{ {k: round(v, 1) for k, v in res['seconds'].items()} }")
    return res


def sharded_serving_phase(kernels, pipe, dev) -> dict:
    """Path A through ``make_sharded`` over [card, card] (two replicas on
    one card) against ``forward`` on the same SS_BATCH frames (drawn faces
    first, then seeded noise): ``has_face`` identical, the int8 limits;
    one crop_frac and one warp launch a replica (every kernel twice path
    A's count); a one-device mesh returns ``forward``."""
    from deepfake_vit_tpu_torch.parallel import make_mesh

    frames = seeded_batches(SS_BATCH, 1, 77)[0]
    frames[:16] = torch.from_numpy(drawn_face_frames(16, SERVING[0], 78))
    if pipe.make_sharded(make_mesh(devices=[dev])) != pipe.forward:
        fail("make_sharded over one device is not forward")
    sharded = pipe.make_sharded(make_mesh(devices=[dev, dev]))
    ref = pipe.forward(frames)
    sharded(frames)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = sharded(frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k.__name__: k.launches for k in kernels}
    t0 = time.perf_counter()
    pipe.forward(frames)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    want = {k: 2 * n for k, n in EXPECTED["A int8 headline"].items()}
    if launches != want:
        fail(f"sharded serving: launches {launches}, expected {want} (two replicas)")
    if not torch.equal(out["has_face"], ref["has_face"]):
        fail("sharded serving: has_face differs from forward")
    err = {k: float((out[k].float() - ref[k].float()).abs().max()) for k in SS_LIMITS}
    print(f"sharded serving, path A over [{dev}, {dev}] (two replicas on one card), B = "
          f"{SS_BATCH}: against forward max_abs {err} (limits {SS_LIMITS}); has_face equal "
          f"({int(ref['has_face'].sum())} faces); launches {launches}; {ms:.2f} ms sharded, "
          f"{forward_ms:.2f} ms forward (host clock, context)")
    if not all(err[k] <= SS_LIMITS[k] for k in SS_LIMITS):
        fail(f"sharded serving: {err} beyond {SS_LIMITS}")
    return {"batch": SS_BATCH, "err": err, "launches": launches, "ms": ms,
            "forward_ms": forward_ms, "faces": int(ref["has_face"].sum())}


def sharded_checkpoint_phase(dev) -> dict:
    """The B4 train state on the card (parameters, statistics, AdamW's
    moments after a step, the step) through ``utils/orbax_io``, bit for
    bit, on its devices and in its dtypes."""
    import copy
    import tempfile

    from deepfake_vit_tpu_torch.configs import TRAINING_CONFIG
    from deepfake_vit_tpu_torch.training import TrainState, make_train_step
    from deepfake_vit_tpu_torch.utils.orbax_io import (restore_checkpoint_sharded,
                                                       save_checkpoint_sharded)

    model, opt, crit = train_setup(copy.deepcopy(TRAINING_CONFIG), torch.float32, dev)
    make_train_step(model, crit, opt)(TrainState(), train_faces(4, 43), 0)
    tree = {"model": model.state_dict(), "optimizer": opt.state_dict(), "step": 1}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        path = save_checkpoint_sharded(tree, Path(work) / "b4")
        save_ms = (time.perf_counter() - t0) * 1e3
        mib = sum(f.stat().st_size for f in path.iterdir()) / 2 ** 20
        t0 = time.perf_counter()
        back = restore_checkpoint_sharded(path, template=tree)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3

    def same(a, b):
        if isinstance(b, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in b)
        if isinstance(b, torch.Tensor):
            return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        return a == b

    ok = same(back, tree)
    print(f"sharded checkpoint: the B4 train state ({mib:.1f} MiB) saved in {save_ms:.0f} ms, "
          f"restored in {restore_ms:.0f} ms, bit for bit on {dev}: {ok}")
    if not ok:
        fail("the sharded checkpoint does not round-trip the train state bit for bit")
    del model, opt, tree, back
    torch.cuda.empty_cache()
    return {"mib": mib, "save_ms": save_ms, "restore_ms": restore_ms}


def cli_phase(kernels, card: str, dev) -> dict:
    """``run_pipeline`` and ``preprocess_dataset`` on the card against
    ``--device cpu`` (in this process, float32 without TF32: the pipeline
    class is wrapped for the run, as the predictor phase compares), the
    committed b0 classifier and SCRFD weights: 16 drawn-face images and a
    cv2-written 12-frame video served, the same rows, labels and face
    counts, fake_prob within CLI_PROB_TOL; a drawn gen_ai tree
    preprocessed, the same rows and splits, the aligned faces within
    CLI_FACE_TOL with fewer than 1 % more than one level apart."""
    import copy
    import csv
    import functools
    import tempfile

    import cv2
    import yaml

    import deepfake_vit_tpu_torch.e2e as e2e
    from deepfake_vit_tpu_torch import preprocess_dataset, run_pipeline
    from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
    from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path
    from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore

    def rows(path):
        with open(path, newline="") as f:
            return list(csv.DictReader(f))

    res = {}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        files = work / "files"
        files.mkdir()
        drawn = drawn_face_frames(16, (320, 480), 61)
        for i, frame in enumerate(drawn):
            cv2.imwrite(str(files / f"img_{i:02d}.png"), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        video = cv2.VideoWriter(str(files / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                                (480, 320))
        for frame in drawn_face_frames(12, (320, 480), 62):
            video.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        video.release()
        classifier = default_weights_path("classifier")
        cfg = work / "b0.yaml"
        cfg.write_text(yaml.safe_dump({"model": msgpack_restore(classifier)["model_config"]}))
        argv = ["--data-dir", str(files), "--det-size", "320", "--batch-size", "16",
                "--checkpoint", classifier, "--config", str(cfg), "--workers", "1"]
        saved = e2e.FusedPipeline
        e2e.FusedPipeline = functools.partial(saved, dtype=torch.float32)
        try:
            with tf32_off():
                for k in kernels:
                    k.launches = 0
                t0 = time.perf_counter()
                run_pipeline.main(argv + ["--output", str(work / "card.csv")])
                card_s = time.perf_counter() - t0
                launches = {k.__name__: k.launches for k in kernels}
                run_pipeline.main(argv + ["--output", str(work / "cpu.csv"), "--device", "cpu"])
        finally:
            e2e.FusedPipeline = saved
        got, want = rows(work / "card.csv"), rows(work / "cpu.csv")
        prob_err = max(abs(float(g["fake_prob"]) - float(w["fake_prob"]))
                       for g, w in zip(got, want))
        same = ([(g["filename"], g["label"], g["num_faces"]) for g in got]
                == [(w["filename"], w["label"], w["num_faces"]) for w in want])
        faces = sum(int(g["num_faces"]) for g in got)
        print(f"[{card}] run_pipeline CLI, card vs --device cpu (float32): {len(got)} files, "
              f"{faces} frames with a face, rows and labels equal: {same}, fake_prob max_abs "
              f"{prob_err:.2e} (limit {CLI_PROB_TOL}); {card_s:.1f} s on the card, model load "
              f"and kernel warm-up included; launches {launches}")
        if not same or len(got) != 17 or faces < 16 or prob_err > CLI_PROB_TOL:
            fail("run_pipeline CLI: the card disagrees with the CPU")
        if launches["warp_affine_legacy"] < 2:
            fail(f"run_pipeline CLI: the warp kernel was not launched on the card: {launches}")
        res["run_pipeline"] = {"files": len(got), "faces": faces, "fake_prob_err": prob_err,
                               "card_s": card_s, "launches": launches}

        raw = work / "raw"
        for label, seed in (("real", 63), ("fake", 64)):
            (raw / label).mkdir(parents=True)
            for i, frame in enumerate(drawn_face_frames(6, (360, 480), seed)):
                cv2.imwrite(str(raw / label / f"{label}_{i}.png"),
                            cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(raw / "fake" / "blank.png"), np.full((300, 300, 3), 128, np.uint8))
        outs = {}
        for where in ("card", "cpu"):
            pre = copy.deepcopy(PREPROCESSING_CONFIG)
            pre["output"] = {"base_dir": str(work / where)}
            pre["logging"] = {}
            pre["datasets"] = {"gen_ai": {"path": str(raw), "real_folder": "real",
                                          "fake_folder": "fake", "image_extensions": [".png"]}}
            (work / f"{where}.yaml").write_text(yaml.safe_dump(pre))
            with tf32_off():
                t0 = time.perf_counter()
                preprocess_dataset.main(["--config", str(work / f"{where}.yaml"),
                                         "--datasets", "gen_ai"]
                                        + (["--device", "cpu"] if where == "cpu" else []))
                outs[where] = time.perf_counter() - t0
        got = rows(work / "card" / "preprocessing_results.csv")
        want = rows(work / "cpu" / "preprocessing_results.csv")
        keys = ("image_id", "label", "processed", "reason", "face_path")
        same = [tuple(g[k] for k in keys) for g in got] == [tuple(w[k] for k in keys)
                                                          for w in want]
        splits = all([r["image_id"] for r in rows(work / "card" / "splits" / f"{s}.csv")]
                     == [r["image_id"] for r in rows(work / "cpu" / "splits" / f"{s}.csv")]
                     for s in ("train", "val", "test"))
        worst, beyond, pixels = 0, 0, 0
        for g in got:
            if g["processed"] == "True":
                a = cv2.imread(str(work / "card" / g["face_path"])).astype(np.int32)
                b = cv2.imread(str(work / "cpu" / g["face_path"])).astype(np.int32)
                d = np.abs(a - b)
                worst, beyond, pixels = max(worst, int(d.max())), beyond + int((d > 1).sum()), \
                    pixels + d.size
        processed = sum(g["processed"] == "True" for g in got)
        print(f"[{card}] preprocess_dataset CLI, card vs --device cpu: {len(got)} rows, "
              f"{processed} faces, rows equal: {same}, splits equal: {splits}, aligned faces "
              f"max_abs {worst} levels (limit {CLI_FACE_TOL:g}), {beyond / max(pixels, 1):.2e} "
              f"of the values more than 1 apart; {outs['card']:.1f} s on the card, "
              f"{outs['cpu']:.1f} s on the CPU")
        if (not same or not splits or processed < 10 or worst > CLI_FACE_TOL
                or beyond / max(pixels, 1) >= 0.01):
            fail("preprocess_dataset CLI: the card disagrees with the CPU")
        res["preprocess_dataset"] = {"rows": len(got), "faces": processed,
                                     "aligned_max_abs": worst,
                                     "aligned_share_beyond_1": beyond / max(pixels, 1),
                                     "card_s": outs["card"], "cpu_s": outs["cpu"]}
    return res


# Slice 14: the acceptance bars of every family, the promotion gate, the
# per-stage profile of path A, the four probes, the crop-fidelity table,
# the pipeline A/B end to end, the loader harness and the RSS diagnostic.
PROFILE_STAGE_LAUNCHES = {  # per stage of path A at one batch (profile_e2e's names)
    "canvas": {}, "detect_320": {}, "detect_320_int8": {"int8_conv": 25},
    "align_warp_640": {"crop_frac": 1, "warp_affine_legacy": 1}, "quality": {},
    "classify_b128": {"int8_gemm": 44},
    "e2e_fused": {"int8_conv": 25, "crop_frac": 1, "warp_affine_legacy": 1, "int8_gemm": 44}}
PROBE_BATCH = 32
FIDELITY_SCENES, FIDELITY_SEED = 24, 20260818
AB_ARGS = ["--arm", "attn", "model:model.feature_extractor.use_attention=true", "--arm", "plain",
           "model:model.feature_extractor.use_attention=false", "--n-per-class", "8", "--size",
           "160", "--epochs", "1", "--batch-size", "4", "--train-seeds", "42,43", "--face-size",
           "64", "--quiet-children"]


def run_cli(main_fn, argv) -> tuple:
    """A port CLI's ``main(argv)`` in this process, its standard output
    echoed; returns (exit code, the last JSON object it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn([str(a) for a in argv])
    text = buf.getvalue()
    sys.stdout.write(text)
    last = None
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                last = json.loads(line)
            except json.JSONDecodeError:
                pass
    return rc, last


def acceptance_phase(dev) -> dict:
    """Every family's acceptance bars (``acceptance.py``), committed weights, on the card."""
    from deepfake_vit_tpu_torch import acceptance

    res = {}
    for model in acceptance.FAMILIES:
        t0 = time.time()
        res[model] = {**acceptance.run(model, dev), "seconds": time.time() - t0}
        print(f"acceptance bar, {model}, committed weights, on the card: {res[model]}")
    missed = [k for k, r in res.items() if not r["held"]]
    if missed:
        fail(f"the acceptance bars of {missed} are not met on the card: {res}")
    return res


def _digests(directory: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(directory.glob("*.msgpack"))}


def promotion_phase() -> dict:
    """``promote_weights`` on the card (the bars in a child process, no
    ``--device``): a copy of the committed MTCNN-Lite weights is promoted
    into a temporary directory; a candidate with zeroed convolution weights
    is refused and the destination's file stays as it was. The shipped
    weights directory does not change."""
    import shutil
    import tempfile

    from deepfake_vit_tpu_torch import promote_weights
    from deepfake_vit_tpu_torch.preprocessing.detector import (_WEIGHTS_DIR,
                                                                DEFAULT_WEIGHTS_BY_MODEL)
    from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize

    def zero_kernels(tree):
        if isinstance(tree, dict):
            return {k: np.zeros_like(v) if k == "kernel" else zero_kernels(v)
                    for k, v in tree.items()}
        return tree

    shipped = _digests(_WEIGHTS_DIR)
    src = DEFAULT_WEIGHTS_BY_MODEL["mtcnn"]
    with tempfile.TemporaryDirectory(prefix="dfv_promote_") as tmp:
        tmp = Path(tmp)
        staged, broken, dest = tmp / "staged.msgpack", tmp / "broken.msgpack", tmp / "weights"
        shutil.copyfile(src, staged)
        broken.write_bytes(msgpack_serialize(zero_kernels(msgpack_restore(src))))
        t0 = time.time()
        rc_ok = promote_weights.main([str(staged), "--model", "mtcnn"], dest_dir=dest)
        ok_s = time.time() - t0
        out = dest / src.name
        accepted = rc_ok == 0 and out.exists() and _digests(dest)[src.name] == _digests(tmp)[
            "staged.msgpack"]
        before = _digests(dest)
        t0 = time.time()
        rc_bad = promote_weights.main([str(broken), "--model", "mtcnn"], dest_dir=dest)
        bad_s = time.time() - t0
        refused = rc_bad == 1 and _digests(dest) == before and broken.exists()
    res = {"accepted_rc": rc_ok, "accepted": accepted, "accept_s": ok_s, "refused_rc": rc_bad,
           "refused": refused, "refuse_s": bad_s, "shipped_unchanged": _digests(_WEIGHTS_DIR) == shipped}
    print(f"promotion gate on the card: {res}")
    if not (accepted and refused and res["shipped_unchanged"]):
        fail(f"the promotion gate misbehaved: {res}")
    return res


def profile_phase(card: str) -> dict:
    """``profile_e2e`` on path A at B = 128: the stages' host and device
    ms, the classify sweep, and each stage's launches; the composed stages
    against ``forward`` on the same frames."""
    from deepfake_vit_tpu_torch import profile_e2e

    pipe = profile_e2e.headline_pipeline()
    frames = seeded_batches(128, 1, 11)[0].to(pipe.device)
    res = profile_e2e.profile(pipe, frames, iters=5, warmup=2, sweep=True)
    with torch.inference_mode():
        got = pipe._classify(profile_e2e.staged_state(pipe, frames)["state"])
    want = pipe.forward(frames)
    gap = {k: float((got[k].float() - want[k].float()).abs().max()) for k in want}
    res["composed_vs_forward_max_abs"] = gap
    print(f"[{card}] profile_e2e, path A, B = 128: host ms {res['host_ms']}; device ms "
          f"{res['device_ms']}; launches {res['launches']}; classify sweep "
          f"{res['classify_sweep']}; composed stages vs forward, max abs {gap}")
    if res["launches"] != PROFILE_STAGE_LAUNCHES:
        fail(f"profile_e2e: launches {res['launches']}, expected {PROFILE_STAGE_LAUNCHES}")
    if not (torch.equal(got["has_face"], want["has_face"])
            and all(gap[k] <= SS_LIMITS[k] for k in SS_LIMITS)):
        fail(f"profile_e2e: the composed stages disagree with forward: {gap}")
    dms = res["device_ms"]
    staged = sum(dms[k] for k in ("canvas", "detect_320_int8", "align_warp_640", "quality",
                                  "classify_b128"))
    res["staged_device_ms"] = staged
    if set(dms) != set(res["host_ms"]) or min(dms.values()) <= 0.0:
        fail(f"profile_e2e: a stage has no device time: {dms}")
    if abs(staged - dms["e2e_fused"]) > 0.1 * dms["e2e_fused"]:
        fail(f"profile_e2e: the stages' device ms sum to {staged:.3f}, forward's is "
             f"{dms['e2e_fused']:.3f}: the profiler lost records")
    del pipe
    torch.cuda.empty_cache()
    return res


def probes_phase(card: str, out_dir: Path) -> dict:
    """The four probes at reduced batch; any failed mode or combo fails."""
    from deepfake_vit_tpu_torch import (probe_lite_detect, probe_refine_timing, probe_serving,
                                        probe_warp_kernel)

    res = {"warp_kernel": probe_warp_kernel.probe(batch=128, window=160, iters=10, warmup=2)}
    rc, res["serving_one"] = run_cli(probe_serving.main, ["--batch", PROBE_BATCH, "--iters", 3])
    if rc:
        fail(f"probe_serving (one config) exited {rc}")
    sweep_json = out_dir / "probe_serving_sweep.jsonl"
    sweep_json.unlink(missing_ok=True)
    rc, res["serving_sweep"] = run_cli(probe_serving.main, [
        "--batch", PROBE_BATCH, "--iters", 3, "--int8-static", "--sweep", "128f+d,160b-uw16+L",
        "--json", sweep_json])
    lines = [json.loads(x) for x in sweep_json.read_text().splitlines()]
    if rc or len(lines) != 2 or any("error" in x for x in lines):
        fail(f"probe_serving --sweep exited {rc}: {lines}")
    res["lite_detect"] = probe_lite_detect.probe(batch=PROBE_BATCH * 2, iters=5)
    res["refine_timing"] = probe_refine_timing.probe(batch=PROBE_BATCH, iters=5)
    failed = {k: v["failed"] for k, v in res.items() if isinstance(v, dict) and v.get("failed")}
    print(f"[{card}] probes: {json.dumps(res)}")
    if failed:
        fail(f"probes failed: {failed}")
    torch.cuda.empty_cache()
    return res


def windowed_geometry(images: torch.Tensor, tf: torch.Tensor, window: int, geom: str):
    """``warp_affine_windowed``'s per-face geometry on the images' device:
    the crop's arguments (without frames and window) and the window-space
    affine of the warp."""
    from deepfake_vit_tpu_torch.ops.umeyama import invert_affine
    from deepfake_vit_tpu_torch.ops.warp import (frac_window_levels, max_window_levels,
                                                 window_geometry, window_geometry_frac)

    H, W = images.shape[1:3]
    A_inv = invert_affine(tf)
    idx = torch.arange(tf.shape[0], device=tf.device)
    if geom == "frac":
        level, strip0s, r, off_y, x0f, A_win = window_geometry_frac(
            A_inv, (224, 224), (H, W), window, frac_window_levels(H, window), y_align=16)
        return (strip0s[level.long(), idx], level, r, off_y, x0f), A_win
    level, y0s, x0s, A_win = window_geometry(A_inv, (224, 224), (H, W), window,
                                             max_window_levels((H, W), window), y_align=16)
    return (y0s[level.long(), idx] << level, x0s[level.long(), idx], level), A_win


def fidelity_phase(card: str) -> dict:
    """``measure_crop_fidelity`` on FIDELITY_SCENES scenes over all twelve
    configurations on the card. Each configuration's kernels (crop, then
    warp) are held to their plain versions on the CPU fed the card's own
    geometry: the outputs, and so the RMSE table, must be equal. The same
    configuration run whole on the CPU (its geometry computed there in
    float32) is printed beside it, with the faces whose geometry differs."""
    from deepfake_vit_tpu_torch import measure_crop_fidelity as mcf
    from deepfake_vit_tpu_torch.ops import warp_kernel as wk
    from deepfake_vit_tpu_torch.ops.umeyama import umeyama
    from deepfake_vit_tpu_torch.preprocessing.aligner import FaceAligner

    images, kps = mcf.build_corpus(np.random.default_rng(FIDELITY_SEED), FIDELITY_SCENES, 640)
    configs = mcf.configurations([160, 128], ["block", "frac"], ["legacy", "uw16", "int8"])
    card_res = mcf.fidelity(images, kps, configs, "cuda", keep_outputs=True)
    cpu_res = mcf.fidelity(images, kps, configs, "cpu", keep_outputs=True)
    n = len(images)
    ref = torch.as_tensor(FaceAligner(output_size=(224, 224), device="cpu").reference)
    tf = umeyama(torch.as_tensor(kps, dtype=torch.float32), ref.expand(n, 5, 2))
    imgs_cpu = torch.as_tensor(images)
    frames_cpu = imgs_cpu.to(torch.bfloat16).reshape(n, 640, 640 * 3)
    res = {"scenes": n, "bin_counts": card_res["bin_counts"], "rows": {}}
    bad = []
    for window, geom, tap in configs:
        key = f"w{window}-{geom}-{tap}"
        g_card, A_card = windowed_geometry(imgs_cpu.cuda(), tf.cuda(), window, geom)
        g_cpu, _ = windowed_geometry(imgs_cpu, tf, window, geom)
        g_card = [t.cpu() for t in g_card]
        names = ("y0_l0", "x0", "level") if geom == "block" else (
            "strip0", "level", "r", "off_y", "x0f")
        field = {k: (a.double() != b.double()) for k, a, b in zip(names, g_card, g_cpu)}
        differs = torch.stack(list(field.values())).any(dim=0)
        crop_fn = (wk.crop_pool if geom == "block" else
                   wk.crop_frac if tap == "legacy" else wk.crop_frac_mxu)
        crop = crop_fn(frames_cpu, *g_card, window, 3)
        plain = wk.WARP_KERNELS[tap](crop.reshape(n, window, window, 3), A_card.cpu(),
                                     (224, 224), inverse=True).numpy()
        diff = float(np.abs(card_res["outputs"][key] - plain).max())
        whole_cpu = float(np.abs(card_res["outputs"][key] - cpu_res["outputs"][key]).max())
        res["rows"][key] = {"rmse": card_res["results"][key],
                            "cpu_rmse": cpu_res["results"][key], "max_abs_vs_plain": diff,
                            "max_abs_vs_cpu_run": whole_cpu,
                            "faces_geometry_differs": int(differs.sum()),
                            "geometry_fields_differ": {k: int(v.sum()) for k, v in field.items()
                                                       if v.any()},
                            "card_s": card_res["seconds"][key]}
        print(f"[{card}] crop fidelity {key:20s} "
              + "  ".join(f"{k}={v:.4f}" for k, v in card_res["results"][key].items())
              + f"   kernels vs plain (card geometry) max abs {diff}; the CPU run pooled "
              f"{cpu_res['results'][key]['pooled']:.4f}, max abs {whole_cpu}, "
              f"{int(differs.sum())} faces with other geometry "
              f"{res['rows'][key]['geometry_fields_differ']}")
        if diff > 0.0:
            bad.append(key)
    if bad:
        fail(f"crop fidelity: the kernels differ from their plain versions on {bad}")
    return res


def pipeline_ab_phase(card: str) -> dict:
    """``experiment_pipeline_ab`` end to end by subprocess on the card at
    the smallest size (b0, 64² faces, one epoch, two seeds)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="dfv_ab_") as ws:
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "deepfake_vit_tpu_torch.experiment_pipeline_ab",
                               "--workdir", ws, *AB_ARGS], cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        secs = time.time() - t0
        summary = (json.loads((Path(ws) / "summary.json").read_text())
                   if (Path(ws) / "summary.json").exists() else None)
    print(f"[{card}] experiment_pipeline_ab by subprocess: exit {proc.returncode} in {secs:.1f} s; "
          f"summary {json.dumps(summary)}")
    if proc.returncode or not summary or summary["delta_seeds"] != [42, 43] or not all(
            math.isfinite(v) for v in summary["auc_control"]["per_seed"]
            + summary["auc_treat"]["per_seed"]):
        fail(f"experiment_pipeline_ab failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return {"seconds": secs, "summary": summary}


def loader_and_rss_phase(card: str) -> dict:
    """``bench_dataloader`` (the cv2 path; the native decoder does not
    build on this machine, which the run must say) and ``diag_rss`` for
    two epochs, over a drawn processed directory."""
    import tempfile

    from deepfake_vit_tpu_torch import bench_dataloader, diag_rss
    from deepfake_vit_tpu_torch.tools.synth_processed import write_processed

    with tempfile.TemporaryDirectory(prefix="dfv_proc_") as tmp:
        write_processed(Path(tmp), counts=(256, 32, 32), size=224, seed=3)
        rc, loader = run_cli(bench_dataloader.main, ["--processed-dir", tmp, "--batch-size", 32,
                                                     "--num-workers", 4, "--batches", 6])
        if rc or not loader or loader.get("python threads") is None:
            fail(f"bench_dataloader exited {rc}: {loader}")
        rc, rss = run_cli(diag_rss.main, ["--processed-dir", tmp, "--epochs", 2,
                                          "--batch-size", 16, "--action", "clear"])
        if rc or not rss or len(rss["rss_mb"]) != 3:
            fail(f"diag_rss exited {rc}: {rss}")
    print(f"[{card}] bench_dataloader: {loader}; diag_rss: {rss}")
    torch.cuda.empty_cache()
    return {"bench_dataloader": loader, "diag_rss": rss}



def card_vs_cpu(path: str, frames: np.ndarray, limits: dict) -> dict:
    """The pipeline on the card against the same pipeline on the CPU (plain
    kernel versions), float32 without TF32; path A hands the card's
    calibrated scales to the CPU side."""
    outs, scales = {}, None
    with tf32_off():
        for where in ("cuda", "cpu"):
            p = build_pipeline(path, torch.float32, where, scales)
            if path.startswith(("A", "E", "G")):
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


def classify_kernel(name: str, classes=KERNEL_CLASSES) -> str:
    low = name.lower()
    for label, keys in classes:
        if any(k in low for k in keys):
            return label
    return "elementwise / other"


@contextlib.contextmanager
def module_ranges(named: dict):
    """A ``record_function`` range named ``named[module]`` around each
    forward of each module (forward hooks; removed on exit)."""
    from torch.profiler import record_function

    handles, stack = [], []

    def pre(name):
        r = record_function(name)
        r.__enter__()
        stack.append(r)

    def post(module, args, out):
        stack.pop().__exit__(None, None, None)

    for module, name in named.items():
        handles.append(module.register_forward_pre_hook(lambda m, a, name=name: pre(name)))
        handles.append(module.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def profile_batch(pipe, frames, batch_ms: float, classes=KERNEL_CLASSES,
                  ranges: Optional[dict] = None) -> dict:
    """One served batch under torch.profiler: device time by kernel and by
    class; with ``ranges`` ({module: name}), also the device time of the
    kernels launched inside each named module's forwards (summed per name)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = set((ranges or {}).values())
    with module_ranges(ranges or {}), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.forward(frames)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = defaultdict(float)
    by_range = defaultdict(float)
    for ev in prof.key_averages():
        # A range also appears as a device row spanning its kernels: not
        # device work of its own.
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.key not in names:
            by_kernel[ev.key] += ev.self_device_time_total
        elif ev.device_type == torch.autograd.DeviceType.CPU and ev.key in names:
            by_range[ev.key] += ev.device_time_total
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time")
    by_class = defaultdict(float)
    for name, us in by_kernel.items():
        by_class[classify_kernel(name, classes)] += us
    out = {
        "profiled_wall_us": wall_us, "device_busy_us": busy_us,
        # Against the unprofiled batch time: the profiler slows the host.
        "device_idle_share": max(0.0, 1.0 - busy_us / (batch_ms * 1e3)),
        "device_us_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_us": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12],
    }
    if ranges:
        out["device_us_by_module"] = {name: by_range.get(name, 0.0) for name in sorted(names)}
    return out


def main() -> None:
    t_start = time.time()
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
    # Path A by stage first, while the profiler sees every kernel: later in
    # the run (after the data-parallel and CLI phases) its sessions have
    # lost the elementwise kernels' records.
    t14 = time.time()
    profile = profile_phase(card)
    profile_s = time.time() - t14

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
    geometry_rows = check_warp_geometry(wk, dev)
    pool_rows = check_crop_pool(wk, frames_flat, A_inv, dev)
    del frames, frames_flat
    gemm_rows = check_int8_gemm(ik, dev)
    # The detector's convolutions as path A launches them in one served batch.
    pipe_a = build_pipeline("A int8 headline")
    convs, k_major = detector_conv_shapes(pipe_a.forward, seeded_batches(BATCH, 1, 7)[0])
    if len(convs) != EXPECTED["A int8 headline"]["int8_conv"] or not k_major:
        fail(f"path A launched {len(convs)} detector convolutions, K-major kernels {k_major}")
    conv_rows = check_int8_conv(ik, dev, convs, k_major)
    stem_rows, block_rows, proto_rows = check_fused(fs, fm, dev)
    s2d_context = s2d_prefix_context(dev)
    torch.cuda.empty_cache()

    # 4. The inference entry point and the preprocessing pipeline: the
    #    whole-frame warp at the predictor's shapes, the predictor on its
    #    clips, the pipeline's one-graph batch. Before the serving rounds,
    #    so that the profiles of phase 7 stay last (see device_ms on the
    #    records the profiler loses late in a run).
    kernels = (wk.crop_frac, wk.crop_frac_mxu, wk.crop_pool, wk.warp_affine_legacy,
               wk.warp_affine_uw, wk.warp_affine_uw16, wk.warp_affine_int8, ik.int8_gemm,
               ik.int8_conv, fs.run_stem, fs.run_block, fm.fused_mbconv)
    if tuple(k.__name__ for k in kernels) != KERNEL_NAMES:
        fail("the counted kernels are not KERNEL_NAMES")
    whole_rows = check_whole_frame_warp(wk, whole_frame_inputs(dev), POOL_FACE)
    predictor = predictor_phase(kernels, dev)
    pipeline = pipeline_phase(kernels, clip_frames(PREDICTOR_CLIPS["640x640"]), dev)
    torch.cuda.empty_cache()
    training = training_phase(kernels, wk, card, dev)
    # 4c-4f. The predictor with each new detector family, the families'
    #    acceptance bars, detector training, the loaders feeding T.
    families = {family: predictor_phase(kernels, dev, family) for family in DETECTOR_FAMILIES}
    t14 = time.time()
    bars = acceptance_phase(dev)
    slice14_s = profile_s + time.time() - t14
    detector_training = detector_training_phase(kernels, card, dev)
    loaders = loader_phase(kernels, card, dev)
    torch.cuda.empty_cache()
    # 4g-4h. The ViT fallback family: the HOG + ViT predictor, the ViT train step.
    vit_predictor = vit_predictor_phase(kernels, dev)
    vit_training = vit_training_phase(kernels, card, dev, training["rounds"])
    torch.cuda.empty_cache()
    # 4i-4l. Data parallelism, sharded serving, the sharded checkpoint, the CLIs.
    t_new = time.time()
    data_parallel = data_parallel_phase(card, dev)
    sharded = sharded_serving_phase(kernels, pipe_a, dev)
    checkpoint = sharded_checkpoint_phase(dev)
    clis = cli_phase(kernels, card, dev)
    new_phases_s = time.time() - t_new
    print(f"data-parallel, sharded serving, checkpoint and CLI phases: {new_phases_s:.1f} s")
    torch.cuda.empty_cache()
    # 4m-4r. The promotion gate, the per-stage profile, the probes, the
    #    fidelity table, the pipeline A/B, the loader harness and diag_rss.
    t14 = time.time()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    slice14 = {"acceptance_s": slice14_s, "promotion": promotion_phase(),
               "profile_e2e": profile, "probes": probes_phase(card, out_dir),
               "crop_fidelity": fidelity_phase(card), "pipeline_ab": pipeline_ab_phase(card),
               **loader_and_rss_phase(card)}
    slice14_s += time.time() - t14
    slice14["seconds"] = slice14_s
    print(f"acceptance, promotion, profile, probe, fidelity, A/B, loader and RSS phases: "
          f"{slice14_s:.1f} s")

    # 5. Each pipeline on the card vs on the CPU (plain kernel versions),
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
        "G s2d + int8 headline": card_vs_cpu("G s2d + int8 headline", faces, int8_limits),
    }
    # Path H serves drawn scenes with MTCNN-Lite's face sizes, tiled into the batches.
    h_scenes = h_frames(H_SCENES, 9)
    h_found = h_faces_on_cpu(h_scenes)
    print(f"path {H_PATH}: {int(h_found.sum())} of {H_SCENES} drawn 640² scenes hold a face "
          f"above 0.5 on the CPU (faces of {H_FACES[0]}-{H_FACES[1]} px)")
    if h_found.sum() < 2:
        fail(f"path {H_PATH}: the detector finds faces in {int(h_found.sum())} scenes")
    card_vs_cpu_err[H_PATH] = card_vs_cpu(H_PATH, h_scenes[np.flatnonzero(h_found)[:2]], tight)
    card_vs_cpu_err[I_PATH] = card_vs_cpu(I_PATH, faces, tight)

    # 6 + 7. The ten paths, served in turns (A, B, bf16, C, D, E, F, G, H, I, then back:
    #    end-to-end numbers compare only within one call, and the second
    #    round shows what the order does) and profiled once each. The same
    #    seeded batches feed all of them but H, which serves its drawn scenes.
    seeded = {bsz: seeded_batches(bsz, N_BATCHES, bsz) for bsz in PROFILE_BATCHES}
    drawn = {bsz: tiled_batches(h_scenes, bsz, N_BATCHES) for bsz in PROFILE_BATCHES}
    frames_of = {path: drawn if path == H_PATH else seeded for path in EXPECTED}
    pipes = {path: pipe_a if path == "A int8 headline" else build_pipeline(path)
             for path in EXPECTED}
    paths = {path: {"launches_per_batch": expected, "rounds": [], "profile": []}
             for path, expected in EXPECTED.items()}
    for rnd, order in enumerate((list(EXPECTED), list(EXPECTED)[::-1])):
        for path in order:
            pipe, expected = pipes[path], EXPECTED[path]
            face = pipe.output_size
            feat = (pipe.model.feature_dim if path == I_PATH
                    else pipe.model.feature_extractor.feature_dim)
            K = pipe.keep_top_k
            served = frames_of[path]
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
                if path == I_PATH:
                    prof = {**res, **profile_batch(pipe, served[bsz][0], batch_ms,
                                                   VIT_KERNEL_CLASSES, vit_ranges(pipe))}
                    vit_ms = prof["device_us_by_module"]["ViT-B/16 forward"] / 1e3
                    flops = vit_flops(bsz)
                    prof["vit_bound"] = {"flops": flops, "bound_ms": flops / BF16_OPS_PER_S * 1e3,
                                         "device_ms": vit_ms}
                    if bsz == BATCH:
                        prof["trace"] = trace_names_warp(pipe, served[bsz][0])
                else:
                    prof = {**res, **profile_batch(pipe, served[bsz][0], batch_ms)}
                paths[path]["profile"].append(prof)
                print(f"    profiled batch: device busy {prof['device_busy_us'] / 1e3:.3f} ms, "
                      f"idle share {prof['device_idle_share']:.3f}")
                for label, us in prof["device_us_by_class"].items():
                    print(f"    {label:34s} {us / 1e3:8.3f} ms")
                for label, us in prof.get("device_us_by_module", {}).items():
                    print(f"    [module] {label:25s} {us / 1e3:8.3f} ms "
                          f"({us / prof['device_busy_us']:.3f} of busy)")
                if "vit_bound" in prof:
                    vb = prof["vit_bound"]
                    print(f"    ViT-B/16 at B = {bsz}: {vb['flops'] / 1e12:.3f} TFLOP, bound "
                          f"{vb['bound_ms']:.3f} ms at 989 TFLOP/s bf16; its device time "
                          f"{vb['device_ms']:.3f} ms "
                          f"({vb['device_ms'] / vb['bound_ms']:.2f}x the bound)")
                for name, us in prof["top_kernels_us"][:6]:
                    print(f"    {us / 1e3:8.3f} ms  {name[:100]}")
    proto_launches = drive_prototype(fm, pipes["C fused backbone"].model, dev)
    if proto_launches != len(PROTO_BLOCKS):
        fail(f"fused_mbconv counted {proto_launches} launches for {len(PROTO_BLOCKS)} calls")
    uw_launches = drive_uw(kernels, seeded[BATCH][0], dev)
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
        if "batch" in m:  # int8_conv: sums over the detector's launches of a batch
            out["batch"] = m["batch"]
        return out

    report = {"kernels": [
        row("crop_frac", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:564",
            a_launches["crop_frac"], crop_row, construction="legacy"),
        row("crop_frac_mxu", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:564",
            e_launches["crop_frac_mxu"], mxu_row, construction="mxu"),
        row("warp_affine_legacy", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            a_launches["warp_affine_legacy"], legacy_row,
            [legacy_row, *whole_rows, training["warp_row"]], construction="legacy"),
        row("warp_affine_uw", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            uw_launches["warp_affine_uw"], rank1_rows["warp_affine_uw"], construction="uw"),
        row("warp_affine_uw16", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            f_launches["warp_affine_uw16"], rank1_rows["warp_affine_uw16"], construction="uw16"),
        row("warp_affine_int8", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            e_launches["warp_affine_int8"], int8_row, construction="int8"),
        row("crop_pool", "warp.cu", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:356",
            b_launches["crop_pool"], pool_rows[0], pool_rows),
        row("int8_gemm", "int8.cu", "deepfake_vit_tpu/models/int8_tail.py:42",
            a_launches["int8_gemm"], gemm_rows[0], gemm_rows),
        row("int8_conv", "int8.cu", "deepfake_vit_tpu/models/scrfd_int8.py:160",
            a_launches["int8_conv"], conv_rows[0], conv_rows),
        row("run_stem", "fused.cu", "deepfake_vit_tpu/ops/pallas/fused_stages.py:372",
            c_launches["run_stem"], stem_rows[0], stem_rows),
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
             "warp_geometry": geometry_rows,
             "crop_pool": pool_rows, "card_vs_cpu": card_vs_cpu_err, "paths": paths,
             "device_launches_per_fused_block": fs.LAUNCHES_PER_BLOCK,
             "s2d_context": s2d_context, "predictor": predictor,
             "whole_frame_warp": whole_rows, "preprocessing_pipeline": pipeline,
             "training": training, "predictor_families": families, "detector_bars": bars,
             "detector_training": detector_training, "loaders": loaders,
             "vit_predictor": vit_predictor, "vit_training": vit_training,
             "data_parallel": data_parallel, "sharded_serving": sharded,
             "sharded_checkpoint": checkpoint, "clis": clis, "new_phases_s": new_phases_s,
             "slice14": slice14,
             "torch": torch.__version__, "cuda": torch.version.cuda}
    timings = [k["ms"] for k in report["kernels"]] + [
        r["faces_per_s"] for v in paths.values() for r in v["rounds"]]
    if not all(math.isfinite(v) for v in timings):
        fail("a timing is not finite")
    wall = time.time() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps({**report, **extra, "wall_s": wall},
                                                        indent=1))
    print(f"chip_smoke wall time: {wall:.1f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
