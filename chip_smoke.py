"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds the CUDA kernels from ``deepfake_vit_tpu_torch/csrc``.
3. Holds each kernel against its plain PyTorch version at the serving
   path's shapes (640² frames, window 128, 192² faces) and times kernel,
   plain version and the nearest single PyTorch call (``F.grid_sample``,
   a yardstick the port never calls) with CUDA events: the median and
   range of several repeats.
4. Checks the pipeline on the card against the same pipeline on the CPU
   (plain kernel versions, float32) on a small input.
5. Serves the headline path — EfficientNet-B4 at full width and depth
   (seeded weights), committed SCRFD weights, 320² detection on 640²
   uint8 frames, fractional window-128 warp, 192² faces, bf16 — for a few
   batches, with every kernel's launch count reset just before and read
   just after.
6. Where the serving time goes: faces/s at a second batch size, then one
   batch per size under ``torch.profiler`` — device busy time against the
   batch time (the idle share), device time by kernel class, top kernels.

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
SERVING, DETECT, WINDOW, FACE = (640, 640), (320, 320), 128, (192, 192)
BATCH, N_BATCHES = 32, 4
PROFILE_BATCHES = (BATCH, 128)
# Kernel vs plain version: both apply the same rounding points, so they
# agree bit for bit; the limit is one bf16 ulp of a [128, 256) pixel.
CROP_TOL, WARP_TOL = 1.0, 1.0

# Kernel-name fragments → class for the profile, first match wins.
KERNEL_CLASSES = (
    ("host <-> device copy", ("memcpy",)),
    ("crop_frac (port kernel)", ("crop_frac_kernel",)),
    ("warp_affine_legacy (port kernel)", ("warp_legacy_kernel",)),
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


def fmt(t: dict) -> str:
    return f"{t['median']:.4f} [{t['min']:.4f}, {t['max']:.4f}]"


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


def headline_pipeline(dtype=torch.bfloat16, device=None):
    from deepfake_vit_tpu_torch.configs import MODEL_CONFIG
    from deepfake_vit_tpu_torch.e2e import FusedPipeline

    pipe = FusedPipeline(MODEL_CONFIG, detection_input_size=DETECT, serving_size=SERVING,
                         output_size=FACE, warp_window=WINDOW, warp_fractional=True,
                         warp_tap_mode="legacy", confidence_threshold=0.0, dtype=dtype,
                         device=device)
    pipe.load_variables(seed=0)
    return pipe


def seeded_batches(batch: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (batch, *SERVING, 3), dtype=np.uint8))
            for _ in range(n)]


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

    from deepfake_vit_tpu_torch.ops import warp_kernel as wk
    from deepfake_vit_tpu_torch.ops.warp import frac_window_levels, window_geometry_frac

    import torch.nn.functional as F

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
    crop_k = wk.crop_frac(*crop_args)
    torch.cuda.synchronize()
    crop_p = wk.crop_frac_plain(*plain_args)
    crop_err = (crop_k.float() - crop_p.float()).abs().max().item()
    crop_t = time_ms(lambda: wk.crop_frac(*crop_args))
    crop_plain_t = time_ms(lambda: wk.crop_frac_plain(*plain_args), iters=5, repeats=5)
    # Yardstick: one grid_sample computing the same bilinear resample.
    i = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    gy = (strip0.float() + off_y)[:, None] + (i + 0.5) * r[:, None] - 0.5
    gx = x0f[:, None] + (i + 0.5) * r[:, None] - 0.5
    grid = torch.stack(torch.broadcast_tensors(
        ((2 * gx + 1) / W - 1)[:, None, :], ((2 * gy + 1) / H - 1)[:, :, None]), -1)
    frames_nchw = frames.permute(0, 3, 1, 2).float().contiguous()
    crop_lib_t = time_ms(lambda: F.grid_sample(frames_nchw, grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=False))
    crop_bytes = (crop_footprint_bytes(strip0, level, r, off_y, x0f, H, W, C)
                  + N * WINDOW * WINDOW * C * 2 + N * 6 * 4)
    print(f"crop_frac: max_abs {crop_err} (tol {CROP_TOL}) kernel_ms {fmt(crop_t)} "
          f"plain_ms {fmt(crop_plain_t)} grid_sample_ms {fmt(crop_lib_t)} "
          f"bound_us {crop_bytes / HBM_BYTES_PER_S * 1e6:.2f} ({crop_bytes} bytes)")
    if not crop_err <= CROP_TOL:
        fail(f"crop_frac disagrees with its plain version: {crop_err}")

    crop = crop_k.reshape(N, WINDOW, WINDOW, C)
    coeffs = A_win.reshape(N, 6).float().contiguous()
    warp_k = wk.warp_affine_legacy(crop, A_win, FACE, inverse=True)
    torch.cuda.synchronize()
    warp_p = wk.warp_affine_legacy_plain(crop, coeffs, FACE)
    warp_err = (warp_k - warp_p).abs().max().item()
    warp_t = time_ms(lambda: wk.warp_affine_legacy(crop, A_win, FACE, inverse=True))
    warp_plain_t = time_ms(lambda: wk.warp_affine_legacy_plain(crop, coeffs, FACE),
                           iters=5, repeats=5)
    ii = torch.arange(FACE[0], dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(FACE[1], dtype=torch.float32, device=dev)[None, :]
    a, b, c, d, e, f = (coeffs[:, k, None, None] for k in range(6))
    wgrid = torch.stack([(2 * (a * jj + b * ii + c) + 1) / WINDOW - 1,
                         (2 * (d * jj + e * ii + f) + 1) / WINDOW - 1], -1)
    crop_nchw = crop.permute(0, 3, 1, 2).float().contiguous()
    warp_lib_t = time_ms(lambda: F.grid_sample(crop_nchw, wgrid, mode="bilinear",
                                               padding_mode="zeros", align_corners=False))
    warp_bytes = (warp_footprint_bytes(coeffs, WINDOW, WINDOW, C, FACE)
                  + N * FACE[0] * FACE[1] * C * 4 + N * 6 * 4)
    print(f"warp_affine_legacy: max_abs {warp_err} (tol {WARP_TOL}) kernel_ms {fmt(warp_t)} "
          f"plain_ms {fmt(warp_plain_t)} grid_sample_ms {fmt(warp_lib_t)} "
          f"bound_us {warp_bytes / HBM_BYTES_PER_S * 1e6:.2f} ({warp_bytes} bytes)")
    if not warp_err <= WARP_TOL:
        fail(f"warp_affine_legacy disagrees with its plain version: {warp_err}")
    del frames, frames_flat, frames_nchw, crop_p, warp_p

    # 4. Pipeline on the card vs on the CPU (plain kernel versions), float32.
    small = np.random.default_rng(5).integers(0, 256, (2, *SERVING, 3), dtype=np.uint8)
    outs = {}
    with tf32_off():
        for where in ("cuda", "cpu"):
            p = headline_pipeline(torch.float32, where)
            outs[where] = {k: v.float().cpu().numpy() for k, v in p.forward(small).items()}
            del p
    ref_err = {k: float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max())
               for k in ("bbox", "landmarks", "quality", "probs")}
    print(f"card vs CPU, float32, 2 frames: max_abs {ref_err}")
    if not (ref_err["bbox"] <= 1e-2 and ref_err["landmarks"] <= 1e-2
            and ref_err["quality"] <= 1e-2 and ref_err["probs"] <= 1e-3):
        fail(f"pipeline on the card disagrees with the CPU reference: {ref_err}")

    # 5. The headline path, served.
    pipe = headline_pipeline()
    served = {BATCH: seeded_batches(BATCH, N_BATCHES, 0)}
    kernels = (wk.crop_frac, wk.warp_affine_legacy)
    warm_up(pipe, served[BATCH][0])
    for k in kernels:
        k.launches = 0
    results, elapsed = serve(pipe, served[BATCH])
    launches = {k.__name__: k.launches for k in kernels}
    faces = BATCH * N_BATCHES
    print(f"served {N_BATCHES} x {BATCH} frames in {elapsed:.3f} s: "
          f"{faces / elapsed:.1f} faces/s on {card}; launches {launches}")
    for out in results:
        if out["probs"].shape != (BATCH, 2) or out["features"].shape != (BATCH, 1792):
            fail(f"bad output shapes {out['probs'].shape}, {out['features'].shape}")
        for key in ("probs", "bbox", "landmarks", "quality", "features", "fake_prob"):
            if not torch.isfinite(out[key].float()).all():
                fail(f"non-finite {key} on the main path")
    if min(launches.values()) < 1:
        fail(f"a kernel of the path was never launched: {launches}")
    del results

    # 6. Where the serving time goes, per batch size.
    profile = []
    for bsz in PROFILE_BATCHES:
        if bsz == BATCH:
            secs = elapsed
        else:
            served[bsz] = seeded_batches(bsz, N_BATCHES, bsz)
            warm_up(pipe, served[bsz][0])
            secs = serve(pipe, served[bsz])[1]
        batch_ms = secs * 1e3 / N_BATCHES
        res = {"batch": bsz, "faces_per_s": bsz * N_BATCHES / secs, "ms_per_batch": batch_ms,
               **profile_batch(pipe, served[bsz][0], batch_ms)}
        profile.append(res)
        print(f"[{card}] batch {bsz}: {res['faces_per_s']:.1f} faces/s, {batch_ms:.2f} ms/batch; "
              f"profiled batch: device busy {res['device_busy_us'] / 1e3:.3f} ms, "
              f"idle share {res['device_idle_share']:.3f}")
        for label, us in res["device_us_by_class"].items():
            print(f"    {label:34s} {us / 1e3:8.3f} ms")
        for name, us in res["top_kernels_us"][:6]:
            print(f"    {us / 1e3:8.3f} ms  {name[:100]}")

    def row(name, replaces, err, t, plain, nbytes, lib):
        return {"name": name, "route": "cuda", "source": "deepfake_vit_tpu_torch/csrc/warp.cu",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err,
                "ms": t["median"], "plain_ms": plain["median"],
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": lib["median"]}

    report = {"kernels": [
        row("crop_frac", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:564",
            crop_err, crop_t, crop_plain_t, crop_bytes, crop_lib_t),
        row("warp_affine_legacy", "deepfake_vit_tpu/ops/pallas/warp_kernel.py:101",
            warp_err, warp_t, warp_plain_t, warp_bytes, warp_lib_t),
    ]}
    extra = {"card": card, "kind": kind, "faces_per_s": faces / elapsed, "served_s": elapsed,
             "kernel_faces": N, "crop_buckets": hist, "r_eq_1_faces": n_r1,
             "timings_ms": {"crop_frac": crop_t, "crop_frac_plain": crop_plain_t,
                            "crop_grid_sample": crop_lib_t, "warp_affine_legacy": warp_t,
                            "warp_plain": warp_plain_t, "warp_grid_sample": warp_lib_t},
             "bound_bytes": {"crop_frac": crop_bytes, "warp_affine_legacy": warp_bytes},
             "card_vs_cpu": ref_err, "profile": profile,
             "torch": torch.__version__, "cuda": torch.version.cuda}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({**report, **extra}, indent=1))
    if not all(math.isfinite(v) for v in (crop_t["median"], warp_t["median"], faces / elapsed)):
        fail("a timing is not finite")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
