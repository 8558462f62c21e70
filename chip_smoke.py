"""The kernel table of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels GROUP,...] [--root DIR]

Builds the CUDA library from ``deepfake_vit_tpu_torch/csrc`` and times each
hand-written kernel alone at the served shapes of ``PERF.md`` §6's kernel
table. Every row gives the kernel's own device time from ``torch.profiler``
over 20 warmed calls (``device_ms``, with the device launches a call), the
median and range of CUDA events around a wrapper call (host enqueue
included), the plain PyTorch version's event time, the library yardstick's
device time where one PyTorch call computes the same function
(``F.grid_sample``, ``torch._int_mm``, ``F.batch_norm``, ``F.layer_norm``,
``F.scaled_dot_product_attention``: calls the port never makes) and the
bound: the larger of the bytes the call must move at 3.35 TB/s and its
operations at the tensor cores' peak.

Before it is timed, each row's wrapper call is held once to its plain
version on the same inputs (``max_abs_err``, within the tolerance of
``TOLERANCES``) and to one device launch of its own kernel (the fused
blocks excepted); every row carries its wrapper's launches in one served
batch of each path of ``tests/test_torch_gpu_paths.py``, all counters set to
0 just before the batch. The card tests (``pytest -m gpu
tests/test_torch_gpu_*.py``) hold the kernels at more shapes and the paths
against the CPU; ``benchmark/`` measures the served cells end to end.

``--kernels`` picks groups (default: all): ``crop_frac`` (rows 1, 1b),
``warp`` (2-2d: path A's, path F's and path E's crops, whole frames, the
train step's faces), ``crop_pool`` (3: paths B and F), ``stem`` (4: paths C
and D), ``blocks`` (5, 6: the fused block and the prototype),
``int8_gemm`` (7), ``int8_conv`` (8: the int8 detector's 25 launches),
``epilogue`` (9-11), ``layer_norm`` (12) and ``self_attention`` (13:
the attention core at the served spatial and temporal calls; its check is
against float32 attention, which it must lie as near as the plain version
does). ``--root DIR`` times the
kernels of the checkout under DIR (an earlier commit unpacked with ``git
archive`` into an ignored directory) with this file's measurement, in a
child process that imports that checkout's package, so that two versions
compare within one call on one card.

Prints the card, one line a row, then one JSON line of every row; writes the
same JSON to ``chiprun_out/chip_smoke.json`` (``chip_smoke_<DIR name>.json``
for another checkout). Exits non-zero without a card and when a row fails
its check. With ``--root`` the served batches are left out: the paths are
this checkout's.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import counts, traffic_gen

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
SERVING, WINDOW, FACE = (640, 640), 128, (192, 192)  # path A's frames, crop window, faces
POOL_WINDOW, POOL_FACE = 160, (224, 224)  # FusedPipeline's default warp and face size
BATCH, MULTI_K = 32, 3  # path F: 32 frames, 3 face slots each
GROUPS = ("crop_frac", "warp", "crop_pool", "stem", "blocks", "int8_gemm", "int8_conv",
          "epilogue", "layer_norm", "self_attention")

# GEMM shapes of path A's int8 tail at B = 128 (rows = 128 x H x W): largest
# M, a mid shape, largest K.
GEMM_SHAPES = ((128 * 576, 56, 336), (128 * 144, 160, 960), (128 * 36, 2688, 448))
# The int8 detector's convolutions on its 320² canvas, (H, Cin, Cout, k,
# stride): launches a served batch.
DETECTOR_CONVS = {(160, 32, 32, 3, 2): 1, (80, 32, 64, 3, 2): 1, (80, 32, 64, 1, 2): 1,
                  (40, 64, 64, 3, 1): 6, (40, 64, 128, 3, 2): 1, (40, 64, 128, 1, 2): 1,
                  (20, 64, 64, 3, 1): 3, (20, 128, 128, 3, 1): 3, (20, 128, 256, 3, 2): 1,
                  (20, 128, 256, 1, 2): 1, (10, 64, 64, 3, 1): 3, (10, 256, 256, 3, 1): 3}
# The stem at path C's faces (B = 128, 192²) and path D's (B = 32, 224²).
STEM_SHAPES = ((128, FACE), (BATCH, POOL_FACE))
# Fused blocks (variant, flat block index, input side, batch): B4 blocks 1-7
# at the 192² path's resolutions; B4 block 17 at 14² is the widest block of
# the 224² path (cexp 960); b6 block 24 (cout 200, cexp 1200) and b7 block
# 29 (cout 224, cexp 1344) are the widest blocks the fused runner plans for
# those variants at 224², whose projection runs in two groups of output
# channels (seeded weights of that one block).
FUSED_BLOCKS = (("b4", 1, 96, 128), ("b4", 2, 96, 128), ("b4", 3, 48, 128), ("b4", 6, 48, 128),
                ("b4", 7, 24, 128), ("b4", 17, 14, 32), ("b6", 24, 14, 32), ("b7", 29, 14, 32))
PROTO_BLOCKS = ((3, 48, 128), (12, 14, 128))  # the prototype: B4 block, side, batch
# The B4's BatchNorm epilogues at the served shapes (B = 128, 224² faces):
# kernel, C, side, which one.
EPILOGUE_SHAPES = (("bn_act", 144, 112, "block 2's expand"), ("bn_act", 1792, 7, "the head"),
                   ("bn_add", 32, 56, "block 3's bn2 + residual"),
                   ("bn_add", 448, 7, "block 31's bn2 + residual"),
                   ("se_gate", 144, 56, "block 2's gate"), ("se_gate", 2688, 7, "block 31's gate"))
# The transformers' LayerNorms a served batch (B = 128 frames, 224² faces):
# what, the shape whose rows are normalized, eps, and whether the rows are
# x[:, 0] (the TimeSformer's CLS rows, 1,569 · 768 apart in its tokens).
# ViT-B/16: 128 × 197 tokens; TimeSformer-Base: ln_t on 16 clips × 196
# patches × 8 frames, ln1 on 128 frames × 197, ln2 on 16 × 1,569; Swin-B
# (the 46 of its 53 LayerNorms that take the kernel): the patch embedding's
# and stage 1's on 128 × 3,136 tokens of 128, stage 2's on 128 × 784 of 256,
# the merge into stage 2 on 128 × 784 of 512, stage 3's on 128 × 196 of 512.
LAYER_NORM_SHAPES = (("ViT-B/16 ln1, ln2, ln_final", (128, 197, 768), 1e-12, False),
                     ("TimeSformer ln_t", (25088, 768), 1e-6, False),
                     ("TimeSformer ln1", (25216, 768), 1e-6, False),
                     ("TimeSformer ln2", (25104, 768), 1e-6, False),
                     ("TimeSformer ln_final, CLS rows", (16, 1569, 768), 1e-6, True),
                     ("Swin-B embedding norm, stage 1 ln1, ln2", (401408, 128), 1e-5, False),
                     ("Swin-B stage 2 ln1, ln2", (100352, 256), 1e-5, False),
                     ("Swin-B merge into stage 2", (100352, 512), 1e-5, False),
                     ("Swin-B stage 3 ln1, ln2", (25088, 512), 1e-5, False))
# Inputs the timed LayerNorm calls take in turn (25.7 to 102.8 MB each at the
# served shapes), so that no call finds its rows in the 50 MB L2 the one
# before left them in.
LAYER_NORM_ROTATION = 4
# The attention core's calls a served batch (B, L, heads): the ViT's and the
# TimeSformer's spatial attention (128 frames x 197 tokens, 12 a batch each)
# and the TimeSformer's temporal attention (16 clips x 196 patches over 8
# frames, 12 a batch). Each QKV product is 116 MB, past the L2; two inputs in
# turns keep the output of one call out of the next one's reads.
SELF_ATTENTION_SHAPES = (("ViT-B/16 and TimeSformer spatial attention", (128, 197, 12)),
                         ("TimeSformer temporal attention", (3136, 8, 12)))
SELF_ATTENTION_ROTATION = 2
# Whole frames with drawn faces that the predictor's aligner warps (the
# clips of tests/test_torch_gpu_paths.py and two 1080p frames): frames,
# height, width, seed. Each row counts the tiles whose source box outgrows
# the warp's staging budget, which read their taps from device memory.
WHOLE_FRAMES = {"1280x720": (5, 720, 1280, 34), "640x640": (BATCH, 640, 640, 47),
                "1920x1080": (2, 1080, 1920, 33)}
# Kernel against plain version, as the card tests hold them: the crops,
# warps, int8 products and epilogues repeat their plain versions' rounding
# points, bit for bit; the fused stem and blocks sum their 1x1 products in
# another order, two bf16 steps of the value (|k - p| <= 2^-7 max(|p|, 1));
# the LayerNorm's float32 row sums, one bf16 step of the larger value plus
# 2^-16 of the largest output; the attention core keeps its scores in
# float32 where the plain version rounds them to bf16: against float32
# attention on the same inputs its largest and mean differences are at most
# the plain version's.
TOLERANCES = ("bit for bit", "two bf16 steps", "one bf16 step", "nearer float32")
FAILURES = []  # the rows that failed their check, with the reason


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
    call, and the per-kernel split. Ranges' device rows are left out."""
    from deepfake_vit_tpu_torch.utils.profiling import device_work

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # Now and then a profile comes back without its device records, or
    # without some of them (a kernel counted 19 times in 20 calls): every
    # call launches the same kernels, so a count that is no multiple of the
    # calls means lost records, and the profile is taken again. Late in a
    # run every try may lose one record of a kernel; then each kernel's mean
    # over the launches recorded, times its launches a call, stands in.
    events = []
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = [ev for ev in device_work(prof.key_averages()) if ev.self_device_time_total > 0]
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
        raise RuntimeError(f"the profiler saw no device kernel named like {own!r}: "
                           f"{sorted(kernels)}")
    return {"ms": sum(mine), "call_ms": sum(k["ms"] for k in kernels.values()),
            "launches": sum(k["launches"] for k in kernels.values()), "kernels": kernels}


def bound(nbytes: float, ops: float = 0.0, ops_per_s: float = INT8_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the tensor-core peak of their type (default: int8)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fmt(t: dict) -> str:
    return f"{t['median']:.4f} [{t['min']:.4f}, {t['max']:.4f}]"


def beyond(got: torch.Tensor, want: torch.Tensor, tol: str) -> tuple:
    """(max |got - want|, elements beyond ``tol``, one of TOLERANCES)."""
    if got.shape != want.shape:
        raise ValueError(f"kernel output {tuple(got.shape)}, plain {tuple(want.shape)}")
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if tol == "bit for bit":
        limit = torch.zeros_like(diff)
    elif tol == "two bf16 steps":
        limit = 2.0 ** -7 * want.abs().clamp_min(1.0)
    else:
        _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
        limit = torch.ldexp(torch.ones_like(diff), e - 8) + 2.0 ** -16 * want.abs().max()
    return float(diff.max()), int((~(diff <= limit)).sum())


def check_row(name: str, shape: str, run, plain, tol: str, reference=None) -> float:
    """Holds one wrapper call to one call of its plain version within
    ``tol`` (a failure goes to FAILURES); the largest difference. For
    "nearer float32", both against ``reference`` (float32 on the same
    inputs) instead."""
    got, want = run(), plain()
    if tol == "nearer float32":
        ref = reference().float()
        k, p = (got.float() - ref).abs(), (want.float() - ref).abs()
        print(f"{name} {shape}: from float32, max {float(k.max()):g} mean {float(k.mean()):g}; "
              f"the plain version's max {float(p.max()):g} mean {float(p.mean()):g}")
        if not (k.max() <= p.max() and k.mean() <= p.mean()):
            FAILURES.append(f"{name} {shape}: farther from float32 than the plain version")
        return float((got.float() - want.float()).abs().max())
    err, n_beyond = beyond(got, want, tol)
    torch.cuda.synchronize()
    if n_beyond:
        FAILURES.append(f"{name} {shape}: {n_beyond} elements beyond {tol} of the plain version, "
                        f"max_abs_err {err:g}")
    return err


def check_launches(name: str, shape: str, d: dict, own: str, launches: int) -> None:
    """The profile ``d`` saw ``launches`` device launches a call, each of a
    kernel named like ``own`` (not held where the profiler lost them)."""
    if "source" in d:
        print(f"{name} {shape}: no device profile to count launches in ({d['source']})")
    elif d["launches"] != launches or not all(own in k for k in d["kernels"]):
        FAILURES.append(f"{name} {shape}: {d['launches']:g} device launches a call, expected "
                        f"{launches} of {own}: {sorted(d['kernels'])}")


def measure(name: str, shape: str, run, own: str, plain, nbytes: float, ops: float = 0.0,
            ops_per_s: float = INT8_OPS_PER_S, library=None, context=None, iters: int = 20,
            plain_iters: int = 3, tol: str = "bit for bit", launches=1, reference=None) -> dict:
    """One row of the table: ``run`` (the kernel's wrapper call, whose own
    device kernels have ``own`` in their names) held to ``plain`` within
    ``tol`` and timed alone, its plain version ``plain`` and the library yardstick
    ``library`` (a call that computes the same function, or None) beside it,
    its bound; ``context`` (label, call) is a call that computes something
    else, timed for comparison only. ``iters``: the calls a profile spans;
    ``launches``: the device launches a call holds (None: not held);
    ``reference``: the float32 call "nearer float32" holds both to."""
    err = check_row(name, shape, run, plain, tol, reference)  # first: rotating inputs start equal
    t, d = time_ms(run), device_ms(run, own, iters)
    if launches is not None:
        check_launches(name, shape, d, own, launches)
    plain_t = time_ms(plain, iters=plain_iters, repeats=3)
    b_ms, by = bound(nbytes, ops, ops_per_s)
    row = {"kernel": name, "shape": shape, "max_abs_err": err, "tolerance": tol,
           "device_ms": d["ms"], "device_launches": d["launches"], "event_ms": t["median"],
           "event_ms_range": [t["min"], t["max"]], "plain_ms": plain_t["median"],
           "bound_ms": b_ms, "bound_by": by, "bound_share": b_ms / d["ms"],
           "device_kernels": d["kernels"]}
    text = (f"{name} {shape}: max_abs_err {err:g} ({tol}), "
            f"device_ms {d['ms']:.4f} in {d['launches']:g} device launches, "
            f"event_ms {fmt(t)}, plain_ms {plain_t['median']:.4f}, bound_ms {b_ms:.6f} ({by}, "
            f"{b_ms / d['ms']:.1%})")
    if library is not None:
        lib = device_ms(library, iters=iters)
        row.update(library_device_ms=lib["ms"], library_device_launches=lib["launches"])
        text += f"; library device_ms {lib['ms']:.4f} in {lib['launches']:g} launches"
    if context is not None:
        label, call = context
        ctx = device_ms(call, iters=5)
        row["context"] = {"what": label, "device_ms": ctx["ms"], "device_launches": ctx["launches"]}
        text += f"; context, {label}: device_ms {ctx['ms']:.4f} in {ctx['launches']:g} launches"
    print(text)
    return row


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


def serving_frames(dev, n: int = 128) -> torch.Tensor:
    """n seeded uint8 640² frames as the crops read them: (n, H, W·3) bf16."""
    g = torch.Generator(device="cpu").manual_seed(0)
    frames = torch.randint(0, 256, (n, *SERVING, 3), generator=g, dtype=torch.uint8)
    return frames.to(dev).to(torch.bfloat16).reshape(n, SERVING[0], -1)


def frac_geometry(dev, n: int = 128):
    """Path A's fractional crop geometry for ``seeded_geometry(n, 1)``: the
    wrappers' arguments after the frames (float32 r, off_y, x0f), the
    plain version's int32 forms, and the window-space affines."""
    from deepfake_vit_tpu_torch.ops.warp import frac_window_levels, window_geometry_frac

    H, W = SERVING
    level, strip0s, r, off_y, x0f, A_win = window_geometry_frac(
        seeded_geometry(n, 1, dev), FACE, (H, W), WINDOW, frac_window_levels(H, WINDOW),
        y_align=16)
    strip0 = strip0s[level.long(), torch.arange(n, device=dev)]
    args = (strip0, level, r, off_y, x0f, WINDOW, 3)
    plain = (strip0.int(), level.int(), torch.round(r * 65536).int(), off_y.int(), x0f.int(),
             WINDOW, 3, torch.arange(n, device=dev).int())
    return args, plain, A_win


def crop_footprint_bytes(strip0, level, r, off_y, x0f, H, W, C) -> int:
    """Bytes the fractional crop must read: the distinct source pixels its
    taps touch with a nonzero weight (rows inside the face's strip and the
    frame, columns inside the frame). The taps are separable, so a face
    reads the product of its distinct rows and columns."""
    N, dev = strip0.shape[0], strip0.device
    i = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    rows = torch.clamp_max(torch.full_like(level.long(), WINDOW) << level.long(), H)
    sy = off_y[:, None] + (i + 0.5) * r[:, None] - 0.5
    sx = x0f[:, None] + (i + 0.5) * r[:, None] - 0.5
    ty, tx = torch.floor(sy).long(), torch.floor(sx).long()
    ymask = torch.zeros((N, H + 2), dtype=torch.bool, device=dev)
    xmask = torch.zeros((N, W + 2), dtype=torch.bool, device=dev)
    for k in (0, 1):
        t = ty + k
        ok = ((t >= 0) & (t < rows[:, None]) & (strip0[:, None].long() + t < H)
              & counts._nonzero_tap(sy, t))
        ymask.scatter_(1, torch.where(ok, t, torch.full_like(t, H + 1)), True)
        s = tx + k
        ok = (s >= 0) & (s < W) & counts._nonzero_tap(sx, s)
        xmask.scatter_(1, torch.where(ok, s, torch.full_like(s, W + 1)), True)
    return int((ymask[:, : H + 1].sum(1) * xmask[:, : W + 1].sum(1)).sum().item()) * C * 2


def crop_frac_rows(wk, dev) -> list:
    """Rows 1 and 1b: the fractional crop with legacy and rank-1 taps at
    path A's shape, beside one ``F.grid_sample`` computing the same bilinear
    resample."""
    frames = serving_frames(dev)
    args, plain, _ = frac_geometry(dev)
    strip0, level, r, off_y, x0f = args[:5]
    N, (H, W) = frames.shape[0], SERVING
    i = torch.arange(WINDOW, dtype=torch.float32, device=dev)
    gy = (strip0.float() + off_y)[:, None] + (i + 0.5) * r[:, None] - 0.5
    gx = x0f[:, None] + (i + 0.5) * r[:, None] - 0.5
    grid = torch.stack(torch.broadcast_tensors(
        ((2 * gx + 1) / W - 1)[:, None, :], ((2 * gy + 1) / H - 1)[:, :, None]), -1)
    frames_nchw = frames.reshape(N, H, W, 3).permute(0, 3, 1, 2).float().contiguous()
    nbytes = (crop_footprint_bytes(strip0, level, r, off_y, x0f, H, W, 3)
              + N * WINDOW * WINDOW * 3 * 2 + N * 6 * 4)
    shape = f"{N} faces, {H}² frames, window {WINDOW}"
    return [measure(name, shape, lambda fn=fn: fn(frames, *args), "crop_frac",
                    lambda c=construction: wk.crop_frac_plain(frames, *plain, construction=c),
                    nbytes, library=lambda: F.grid_sample(frames_nchw, grid, align_corners=False))
            for name, fn, construction in (("crop_frac", wk.crop_frac, "legacy"),
                                           ("crop_frac_mxu", wk.crop_frac_mxu, "mxu"))]


def warp_grid(coeffs: torch.Tensor, out_size, src_hw) -> torch.Tensor:
    """The normalized sampling grid of ``F.grid_sample`` for the warp with
    dst→src rows ``coeffs`` (N, 6) from an (Hs, Ws) image
    (align_corners=False)."""
    ii = torch.arange(out_size[0], dtype=torch.float32, device=coeffs.device)[:, None]
    jj = torch.arange(out_size[1], dtype=torch.float32, device=coeffs.device)[None, :]
    a, b, c, d, e, f = (coeffs[:, k, None, None] for k in range(6))
    return torch.stack([(2 * (a * jj + b * ii + c) + 1) / src_hw[1] - 1,
                        (2 * (d * jj + e * ii + f) + 1) / src_hw[0] - 1], -1)


def warp_footprint_bytes(coeffs: torch.Tensor, src_hw, out_size, C: int) -> int:
    """Bytes a warp must move: ``counts.warp_bytes`` (the distinct source
    pixels a nonzero bf16 tap touches, read once; the float32 output
    written once) and the affine rows."""
    return counts.warp_bytes(coeffs, src_hw, out_size, C) + coeffs.shape[0] * 6 * 4


def warp_row(wk, name: str, plain_fn, images: torch.Tensor, A_inv: torch.Tensor, out_size,
             shape: str) -> dict:
    """The warp wrapper ``name`` on ``images`` (N, Hs, Ws, C) with dst→src affines
    ``A_inv``, beside ``F.grid_sample`` on the same input and grid. The
    rank-1 and int8 taps have the legacy support, so the footprint is the
    legacy one."""
    N, Hs, Ws, C = images.shape
    coeffs = A_inv.reshape(N, 6).float().contiguous()
    grid, src = warp_grid(coeffs, out_size, (Hs, Ws)), images.permute(0, 3, 1, 2).float()
    src = src.contiguous()
    staged = wk.warp_tile_box(coeffs, out_size, (Hs, Ws), C).staged
    fn = getattr(wk, name)
    return measure(name, f"{shape}, {int((~staged).sum())} of {staged.numel()} tiles from device "
                   f"memory", lambda: fn(images, A_inv, out_size, inverse=True), "warp_",
                   lambda: plain_fn(images, coeffs, out_size),
                   warp_footprint_bytes(coeffs, (Hs, Ws), out_size, C),
                   library=lambda: F.grid_sample(src, grid, align_corners=False))


def whole_frame_inputs(dev) -> dict:
    """Per WHOLE_FRAMES entry, the frames with a face and the dst→src
    affines the predictor's aligner warps them with: its detector and
    aligner (``PREPROCESSING_CONFIG``, 224² faces) on the card."""
    from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
    from deepfake_vit_tpu_torch.ops.umeyama import invert_affine
    from deepfake_vit_tpu_torch.preprocessing.aligner import FaceAligner
    from deepfake_vit_tpu_torch.preprocessing.detector import create_face_detector

    detector = create_face_detector(PREPROCESSING_CONFIG["detection"], device=dev)
    aligner = FaceAligner(output_size=POOL_FACE, device=dev,
                          reference_landmarks=PREPROCESSING_CONFIG["alignment"]["reference_landmarks"])
    out = {}
    for name, (n, h, w, seed) in WHOLE_FRAMES.items():
        frames = traffic_gen.face_frames(n, (h, w), seed, dev)
        dets = detector.batch_detect(list(frames.cpu().numpy()))
        keep = [i for i, d in enumerate(dets) if d is not None]
        if not keep:
            raise RuntimeError(f"no face found in the {name} frames")
        lms = torch.as_tensor(np.stack([dets[i]["landmarks"] for i in keep]), device=dev)
        out[name] = (frames[keep].to(torch.bfloat16), invert_affine(aligner._estimate(lms)))
    return out


def warp_rows(wk, dev) -> list:
    """Rows 2-2d: the legacy warp of path A's crops, the rank-1 warps of
    path F's pooled crops, the int8 warp of path E's rank-1 crops; the legacy
    warp on whole frames and at the train step's shape."""
    from deepfake_vit_tpu_torch.ops.augment import draw_rotation, rotation_matrices
    from deepfake_vit_tpu_torch.ops.umeyama import invert_affine
    from deepfake_vit_tpu_torch.ops.warp import max_window_levels, window_geometry

    frames = serving_frames(dev)
    args, _, A_win = frac_geometry(dev)
    N = frames.shape[0]
    rows = []
    for name, crop_fn in (("warp_affine_legacy", wk.crop_frac),
                          ("warp_affine_int8", wk.crop_frac_mxu)):
        crop = crop_fn(frames, *args).reshape(N, WINDOW, WINDOW, 3)
        plain = wk.warp_affine_int8_plain if name.endswith("int8") else wk.warp_affine_legacy_plain
        rows.append(warp_row(wk, name, plain, crop, A_win, FACE,
                             f"{N} × {WINDOW}² crops -> {FACE[0]}²"))
    n = BATCH * MULTI_K  # path F: 3 face slots on each of 32 frames
    H, W = SERVING
    level, y0s, x0s, A_pool = window_geometry(seeded_geometry(n, 7, dev), POOL_FACE, (H, W),
                                              POOL_WINDOW, max_window_levels((H, W), POOL_WINDOW),
                                              y_align=16)
    idx = torch.arange(n, device=dev)
    crop = wk.crop_pool(frames[:BATCH], y0s[level.long(), idx] << level, x0s[level.long(), idx],
                        level, POOL_WINDOW, 3, frame_idx=idx // MULTI_K)
    crop = crop.reshape(n, POOL_WINDOW, POOL_WINDOW, 3)
    for name in ("warp_affine_uw", "warp_affine_uw16"):
        rows.append(warp_row(wk, name, wk.warp_affine_uw_plain, crop, A_pool,
                             POOL_FACE, f"{n} × {POOL_WINDOW}² crops -> {POOL_FACE[0]}²"))
    del frames, crop
    for name, (images, A_inv) in whole_frame_inputs(dev).items():
        rows.append(warp_row(wk, "warp_affine_legacy", wk.warp_affine_legacy_plain, images,
                             A_inv, POOL_FACE,
                             f"{images.shape[0]} whole {name} frames -> {POOL_FACE[0]}²"))
    faces = traffic_gen.train_faces(32, POOL_FACE, 21, dev)["image"].to(torch.bfloat16)
    theta = draw_rotation(32, 5.0, torch.Generator(device=dev).manual_seed(0), dev)
    A_inv = invert_affine(rotation_matrices(theta, POOL_FACE))
    rows.append(warp_row(wk, "warp_affine_legacy", wk.warp_affine_legacy_plain, faces, A_inv,
                         POOL_FACE,
                         "train step: 32 normalized 224² faces, ±5° rotation -> 224²"))
    return rows


def crop_pool_rows(wk, dev) -> list:
    """Row 3: the pooled crop at path B's shape (128 faces, one frame each,
    frame_idx None) and path F's (96 face slots sharing 32 frames): 640²
    frames, window 160. No single PyTorch call computes it."""
    from deepfake_vit_tpu_torch.ops.warp import max_window_levels, window_geometry

    frames = serving_frames(dev)
    N, (H, W) = frames.shape[0], SERVING
    levels = max_window_levels((H, W), POOL_WINDOW)
    rows = []
    for path, A, fidx in (("B", seeded_geometry(N, 1, dev), None),
                          ("F", seeded_geometry(BATCH * MULTI_K, 7, dev),
                           torch.arange(BATCH * MULTI_K, device=dev).int() // MULTI_K)):
        n = A.shape[0]
        level, y0s, x0s, _ = window_geometry(A, POOL_FACE, (H, W), POOL_WINDOW, levels, y_align=16)
        idx = torch.arange(n, device=dev)
        y0, x0 = y0s[level.long(), idx], x0s[level.long(), idx]
        src = frames if fidx is None else frames[:BATCH]
        args = (src, y0 << level, x0, level, POOL_WINDOW, 3)
        kw = {} if fidx is None else {"frame_idx": fidx}
        plain_args = (src, (y0 << level).int(), x0.int(), level.int(), POOL_WINDOW, 3,
                      idx.int() if fidx is None else fidx)
        hist = torch.bincount(level.long(), minlength=levels).tolist()
        shape = (f"path {path}: {n} faces{'' if fidx is None else f' sharing {BATCH} frames'}, "
                 f"{H}² frames, window {POOL_WINDOW}, levels {hist}")
        rows.append(measure("crop_pool", shape, lambda: wk.crop_pool(*args, **kw), "crop_pool",
                            lambda: wk.crop_pool_plain(*plain_args),
                            counts.crop_pool_bytes(level, y0, x0, (H, W), POOL_WINDOW)))
    return rows


def valid_taps(size: int, out: int, k: int, stride: int, before: int) -> int:
    """Taps of one axis that fall on the image, summed over the outputs."""
    return sum(sum(0 <= o * stride - before + r < size for o in range(out)) for r in range(k))


def int8_gemm_rows(ik, dev) -> list:
    """Row 7: the int8 GEMM at the tail's shapes on K-major weights (as the
    tail runner keeps them), beside ``torch._int_mm`` (the s32 product alone)
    on the faster of K-major and row-major weights; a fill of the float32
    output as context, the store floor."""
    rows = []
    for M, K, N in GEMM_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(M + K + N)
        xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(dev)
        wq = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(dev)
        wk_major = wq.t().contiguous().t()
        sx = torch.tensor([0.0437], device=dev)
        sw = (torch.rand(N, generator=g) * 0.01 + 0.001).to(dev)
        b = torch.randn(N, generator=g).to(dev)
        lib = {layout: device_ms(lambda w=w: torch._int_mm(xq, w))["ms"]
               for layout, w in (("row-major", wq), ("K-major", wk_major))}
        faster = wq if lib["row-major"] <= lib["K-major"] else wk_major
        fill = torch.empty((M, N), device=dev)
        plan = ik.int8_gemm_plan(M, K, N)
        row = measure("int8_gemm", f"({M}, {K}) x ({K}, {N}), tile {plan.tile_m}x{plan.tile_n}, "
                      f"{plan.blocks} blocks", lambda: ik.int8_gemm(xq, wk_major, sx, sw, b),
                      "int8_gemm", lambda: ik.int8_gemm_plain(xq, wq, sx, sw, b),
                      M * K + K * N + 4 * M * N + 4 * (1 + 2 * N), 2.0 * M * K * N,
                      library=lambda: torch._int_mm(xq, faster),
                      context=("a fill (zero_) of the float32 output", fill.zero_))
        row["library_device_ms_by_layout"] = lib
        rows.append(row)
    return rows


def int8_conv_rows(ik, dev, batch: int = 128) -> list:
    """Row 8: the int8 convolution at each of the detector's shapes, its
    kernels K-major as ``ScrfdInt8Runner`` keeps them, and the sums over a
    served batch's 25 launches. No PyTorch call computes an s8 convolution
    on CUDA; the bf16 cuDNN convolution of the same shape is context."""
    from deepfake_vit_tpu_torch.models.layers import same_pads

    rows = []
    for (H, cin, cout, k, stride), n in DETECTOR_CONVS.items():
        g = torch.Generator(device="cpu").manual_seed(H + cin + cout + k)
        xq = torch.randint(-127, 128, (batch, H, H, cin), generator=g, dtype=torch.int8).to(dev)
        kq = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8).to(dev)
        kq = kq.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
        sx = torch.tensor([0.031], device=dev)
        sw = (torch.rand(cout, generator=g) * 0.01 + 0.001).to(dev)
        b = torch.randn(cout, generator=g).to(dev)
        lo, hi = same_pads(H, k, stride)
        x16 = F.pad(xq.permute(0, 3, 1, 2).to(torch.bfloat16), (lo, hi, lo, hi))
        k16 = kq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        Ho = -(-H // stride)
        taps = valid_taps(H, Ho, k, stride, lo)  # padding taps do no work
        row = measure("int8_conv", f"{H}² {cin}→{cout} {k}×{k} s{stride}, B = {batch}",
                      lambda: ik.int8_conv(xq, kq, sx, sw, b, stride), "int8_conv",
                      lambda: ik.int8_conv_plain(xq, kq, sx, sw, b, stride),
                      batch * H * H * cin + k * k * cin * cout + 4 * batch * Ho * Ho * cout
                      + 4 * (1 + 2 * cout), 2.0 * batch * taps * taps * cin * cout,
                      context=("bf16 cuDNN convolution of this shape, a different function",
                               lambda: F.conv2d(x16, k16, None, stride)), plain_iters=2)
        row["launches_per_batch"] = n
        rows.append(row)
    total = {key: sum(r[key] * r["launches_per_batch"] for r in rows)
             for key in ("device_ms", "event_ms", "bound_ms")}
    print(f"int8_conv, the detector's {sum(DETECTOR_CONVS.values())} launches a batch of {batch}: "
          f"device_ms {total['device_ms']:.4f} (event_ms {total['event_ms']:.4f}) against a "
          f"summed bound of {total['bound_ms']:.4f} ms")
    rows[0]["batch"] = {"launches": sum(DETECTOR_CONVS.values()), **total}
    return rows


def stem_rows(fs, dev) -> list:
    """Row 4: the fused stem at STEM_SHAPES on B4's seeded stem and seeded
    faces. Context, not the same function (no SiLU): one cuDNN convolution
    in bf16, channels-last, with the folded weights and bias, on the input
    padded beforehand."""
    from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.ops.image import normalize_imagenet

    bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(3)
    sw = fs.fold_stem_weights(bb)
    c0 = sw[0].shape[0]
    w4 = sw[0].float().reshape(c0, 3, 3, 3).permute(0, 3, 1, 2).to(torch.bfloat16)
    w4 = w4.contiguous(memory_format=torch.channels_last)
    rows = []
    for B, face in STEM_SHAPES:
        faces = torch.randint(0, 256, (B, *face, 3), generator=g, dtype=torch.uint8).to(dev)
        x = normalize_imagenet(faces.float() / 255.0).to(torch.bfloat16)
        x_pad = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)).contiguous(
            memory_format=torch.channels_last)
        ho = face[0] // 2
        taps = valid_taps(face[0], ho, 3, 2, 0)
        rows.append(measure(
            "run_stem", f"({B}, {face[0]}, {face[1]}, 3) -> {c0} channels",
            lambda: fs.run_stem(x, sw), "fused_stem", lambda: fs.run_stem_plain(x, sw),
            x.numel() * 2 + B * ho * ho * c0 * 2 + sw[0].numel() * 2 + c0 * 4,
            2.0 * B * taps * taps * 3 * c0, BF16_OPS_PER_S,
            context=("one bf16 cuDNN conv2d of the folded stem, no SiLU",
                     lambda: F.conv2d(x_pad, w4, sw[1].to(torch.bfloat16), stride=2)),
            tol="two bf16 steps"))
    return rows


def block_bound(bp, B: int, h: int, weights):
    """(bytes, operations) of one MBConv block: input, output and weights
    once; the multiply-adds of expand, depthwise (taps on the image only),
    squeeze-excite and projection, times two."""
    ho = h // bp.stride
    before = bp.kernel // 2 if bp.stride == 1 else (bp.kernel - 2) // 2
    taps = valid_taps(h, ho, bp.kernel, bp.stride, before)
    macs = B * ((h * h * bp.cin * bp.cexp if bp.has_expand else 0) + taps * taps * bp.cexp
                + 2 * bp.cexp * bp.cse + ho * ho * bp.cexp * bp.cout)
    nbytes = (2 * B * (h * h * bp.cin + ho * ho * bp.cout)
              + sum(w.numel() * w.element_size() for w in weights))
    return nbytes, 2.0 * macs


def block_rows(fs, fm, dev) -> list:
    """Rows 5 and 6: the fused block (``run_block``) at FUSED_BLOCKS and the
    single-block prototype (``fused_mbconv``) at PROTO_BLOCKS, on seeded
    weights and inputs; the port's eager module on the same input as
    context (BatchNorm not folded: a different function)."""
    from deepfake_vit_tpu_torch.models.efficientnet import (EfficientNetBackbone, MBConvBlock,
                                                            block_args)
    from deepfake_vit_tpu_torch.models.layers import init_weights

    bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
    # The blocks' inputs follow the first stem input in one seeded stream, as
    # the table's earlier rows were measured.
    g = torch.Generator(device="cpu").manual_seed(3)
    torch.randint(0, 256, (STEM_SHAPES[0][0], *STEM_SHAPES[0][1], 3), generator=g)
    rows = []
    cases = ([("run_block", *c) for c in FUSED_BLOCKS]
             + [("fused_mbconv", "b4", *c) for c in PROTO_BLOCKS])
    for label, variant, idx, h, B in cases:
        if variant == "b4":
            blk, args = getattr(bb, f"block_{idx}"), bb.blocks[idx]
        else:  # one block of a wider variant, seeded
            args = block_args(variant)[idx]
            blk = init_weights(MBConvBlock(**args), idx).to(dev).eval()
        bp = fs.block_plan_from_args(args)
        weights = fs.fold_block_weights(blk, bp)
        x = torch.randn((B, h, h, bp.cin), generator=g).to(dev).to(torch.bfloat16)
        if label == "run_block":
            run, plain = (lambda: fs.run_block(bp, x, weights),
                          lambda: fs.run_block_plain(bp, x, weights))
        else:
            ratio = args["expand_ratio"]
            folded = fm.fold_mbconv_params(blk, ratio)
            run, plain = (lambda: fm.fused_mbconv(x, folded, ratio),
                          lambda: fm.fused_mbconv_plain(x, folded, ratio))
        x_nchw = x.permute(0, 3, 1, 2)

        def eager():
            with torch.inference_mode():
                blk(x_nchw)

        nbytes, ops = block_bound(bp, B, h, weights)
        rows.append(measure(label, f"{variant.upper()} block {idx}, B = {B}, {h}² -> "
                            f"{h // bp.stride}², k{bp.kernel} {bp.cin} -> {bp.cexp} -> {bp.cout}",
                            run, "fused_", plain, nbytes, ops, BF16_OPS_PER_S,
                            context=("the port's eager module", eager), iters=5, plain_iters=2,
                            tol="two bf16 steps", launches=None))
        del x, x_nchw
    return rows


def epilogue_case(be, kind: str, C: int, H: int, dev, B: int = 128):
    """Seeded inputs of one epilogue: the kernel call, its plain version, the
    library yardstick (eager ``F.batch_norm`` on the same channels-last
    tensor, then ``F.silu`` or the residual add; none for the gate, whose
    eager form is the plain version) and the bytes it must move."""
    # Activations and statistics of a served network's scale (BatchNorm
    # outputs within about ±15): past about -88 expf overflows and the
    # division takes its slow path, which the GPU tests cover and served
    # batches do not meet.
    g = torch.Generator(device="cpu").manual_seed(C * H)
    x = (2.0 * torch.randn((B, H, H, C), generator=g)).to(dev, torch.bfloat16).permute(0, 3, 1, 2)
    weight, bias = torch.exp(0.5 * torch.randn(C, generator=g)), 0.5 * torch.randn(C, generator=g)
    mean, var = 0.5 * torch.randn(C, generator=g), torch.exp(0.5 * torch.randn(C, generator=g))
    weight, bias, mean, var = (t.to(dev) for t in (weight, bias, mean, var))
    factors = torch.stack([mean, torch.rsqrt(var + 1e-3) * weight, bias])
    numel = x.numel()

    def lib_bn():
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, 1e-3)

    if kind == "bn_act":
        return (lambda: be.bn_act(x, factors), lambda: be.bn_act_plain(x, factors),
                lambda: F.silu(lib_bn()), 4 * numel + 12 * C)
    if kind == "bn_add":
        r = (2.0 * torch.randn((B, H, H, C), generator=g)).to(dev, torch.bfloat16)
        r = r.permute(0, 3, 1, 2)
        return (lambda: be.bn_add(x, factors, r), lambda: be.bn_add_plain(x, factors, r),
                lambda: lib_bn() + r, 6 * numel + 12 * C)
    gate = torch.sigmoid((3.0 * torch.randn((B, C), generator=g)).to(dev, torch.bfloat16))
    return (lambda: be.se_gate(x, gate), lambda: be.se_gate_plain(x, gate), None,
            4 * numel + 2 * B * C)


def epilogue_rows(dev) -> list:
    """Rows 9-11: the three epilogue kernels at EPILOGUE_SHAPES."""
    from deepfake_vit_tpu_torch.ops import bn_epilogue as be

    rows = []
    for kind, C, H, what in EPILOGUE_SHAPES:
        run, plain, lib, nbytes = epilogue_case(be, kind, C, H, dev)
        rows.append(measure(kind, f"{what}: (128, {C}, {H}, {H}) bf16 channels-last", run,
                            f"{kind}_kernel", plain, nbytes, library=lib, plain_iters=5))
    torch.cuda.empty_cache()
    return rows


def layer_norm_rows(dev) -> list:
    """Row 12: the LayerNorm kernel at LAYER_NORM_SHAPES, each call on the
    next of LAYER_NORM_ROTATION inputs (past the L2), beside ``F.layer_norm``
    in bf16."""
    from deepfake_vit_tpu_torch.ops import layer_norm as ln

    rows = []
    for what, shape, eps, cls_rows in LAYER_NORM_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(sum(shape))
        W = shape[-1]
        xs = [(1.5 + 4.0 * torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
              for _ in range(LAYER_NORM_ROTATION)]
        xs = [x[:, 0] if cls_rows else x for x in xs]
        weight = (1.0 + 0.3 * torch.randn(W, generator=g)).to(dev)
        bias = (0.5 * torch.randn(W, generator=g)).to(dev)
        w16, b16 = weight.to(torch.bfloat16), bias.to(torch.bfloat16)

        def rotating(fn):  # each call its own turn: the first call of each takes xs[0]
            turn = itertools.count()
            return lambda: fn(xs[next(turn) % LAYER_NORM_ROTATION], weight, bias, eps)

        n_rows = xs[0].numel() // W
        rows.append(measure(
            "layer_norm", f"{what}: {n_rows} rows of {W} bf16, eps {eps:g}",
            rotating(ln.layer_norm), "layer_norm_kernel", rotating(ln.layer_norm_plain),
            2 * 2 * n_rows * W + 2 * 4 * W,
            library=rotating(lambda x, w, b, e: F.layer_norm(x, (W,), w16, b16, e)),
            plain_iters=5, tol="one bf16 step"))
        del xs
    torch.cuda.empty_cache()
    return rows


def self_attention_rows(dev) -> list:
    """Row 13: the attention core at SELF_ATTENTION_SHAPES, each call on the
    next of SELF_ATTENTION_ROTATION QKV products, held to float32 attention,
    beside ``F.scaled_dot_product_attention`` on the (B, H, L, 64) views of
    the same product. Bytes: the product read once, O written once."""
    from deepfake_vit_tpu_torch.ops import self_attention as sa

    rows = []
    for what, (B, L, H) in SELF_ATTENTION_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(B + L)
        W = H * sa.HEAD_DIM
        xs = [torch.cat([1.5 * torch.randn((B, L, 2 * W), generator=g),
                         0.5 + torch.randn((B, L, W), generator=g)], -1).to(dev, torch.bfloat16)
              for _ in range(SELF_ATTENTION_ROTATION)]

        def rotating(fn):  # each call its own turn: the first call of each takes xs[0]
            turn = itertools.count()
            return lambda: fn(xs[next(turn) % SELF_ATTENTION_ROTATION])

        def sdpa(x):
            q, k, v = x.view(B, L, 3, H, sa.HEAD_DIM).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v)

        rows.append(measure(
            "self_attention", f"{what}: B {B}, L {L}, {H} heads of {sa.HEAD_DIM}, bf16",
            rotating(lambda x: sa.self_attention(x, H)), "attention_kernel",
            rotating(lambda x: sa.self_attention_plain(x, H)), 2 * 4 * B * L * W,
            ops=4 * B * H * L * L * sa.HEAD_DIM, ops_per_s=BF16_OPS_PER_S,
            library=rotating(sdpa), plain_iters=5, tol="nearer float32",
            reference=lambda: sa.self_attention_plain(xs[0].float(), H)))
        del xs
    torch.cuda.empty_cache()
    return rows


def served_launches() -> dict:
    """Each wrapper's launches in one served batch of each path of
    ``tests/test_torch_gpu_paths.py`` (its pipelines and frames; 128 frames,
    paths D and F 32 as there) after a warm-up batch, every counter set to 0
    just before the batch."""
    spec = importlib.util.spec_from_file_location("gpu_paths",
                                                  ROOT / "tests" / "test_torch_gpu_paths.py")
    gp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gp)
    served = {}
    for path in gp.PATHS:
        n = max(gp.PATH_BATCHES[path])
        frames, pipe = gp.served_frames(path, n), gp.build_pipeline(path)
        pipe.forward(frames)
        torch.cuda.synchronize()
        for k in gp.kernels():
            k.launches = 0
        pipe.forward(frames)
        torch.cuda.synchronize()
        served[path] = {k.__name__: k.launches for k in gp.kernels()}
        print(f"path {path}, one served batch of {n}: "
              + ", ".join(f"{k} {v}" for k, v in served[path].items() if v))
        del pipe
        torch.cuda.empty_cache()
    return served


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help=f"comma-separated groups to time, of {', '.join(GROUPS)}")
    ap.add_argument("--root", help="directory holding another checkout's deepfake_vit_tpu_torch")
    opts = ap.parse_args(argv)
    groups = opts.kernels.split(",")
    if not set(groups) <= set(GROUPS):
        ap.error(f"--kernels takes {GROUPS}, got {groups}")
    if opts.root and Path(opts.root).resolve() != ROOT:
        # Python's -P leaves this file's directory off the path: the child
        # imports the other checkout's package (and its benchmark/, else ours).
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(Path(opts.root).resolve()),
                                                              str(ROOT)])}
        return subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()), "--kernels",
                               opts.kernels], env=env).returncode
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    import deepfake_vit_tpu_torch
    from deepfake_vit_tpu_torch.ops import fused_mbconv as fm
    from deepfake_vit_tpu_torch.ops import fused_stages as fs
    from deepfake_vit_tpu_torch.ops import int8_kernel as ik
    from deepfake_vit_tpu_torch.ops import warp_kernel as wk

    package_root = Path(deepfake_vit_tpu_torch.__file__).resolve().parents[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}; the kernels of "
          f"{package_root}")
    t0 = time.time()
    lib = wk.build_library(verbose=True)
    print(f"build: {time.time() - t0:.1f} s -> {lib.name}")
    dev = torch.device("cuda")
    timers = {"crop_frac": lambda: crop_frac_rows(wk, dev), "warp": lambda: warp_rows(wk, dev),
              "crop_pool": lambda: crop_pool_rows(wk, dev), "stem": lambda: stem_rows(fs, dev),
              "blocks": lambda: block_rows(fs, fm, dev), "int8_gemm": lambda: int8_gemm_rows(ik, dev),
              "int8_conv": lambda: int8_conv_rows(ik, dev), "epilogue": lambda: epilogue_rows(dev),
              "layer_norm": lambda: layer_norm_rows(dev),
              "self_attention": lambda: self_attention_rows(dev)}
    report = {"card": card, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "cuda": torch.version.cuda, "root": str(package_root), "rows": {}}
    for group in groups:
        report["rows"][group] = timers[group]()
        torch.cuda.empty_cache()
    if package_root == ROOT:
        report["served_launches"] = served_launches()
        for row in (r for rows in report["rows"].values() for r in rows):
            row["served_launches"] = {path: c[row["kernel"]]
                                      for path, c in report["served_launches"].items()
                                      if c.get(row["kernel"])}
    report["wall_s"] = time.time() - t0
    report["failures"] = FAILURES
    out = ROOT / "chiprun_out" / ("chip_smoke.json" if package_root == ROOT
                                  else f"chip_smoke_{package_root.name}.json")
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    for failure in FAILURES:
        print(f"FAIL {failure}", file=sys.stderr)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    raise SystemExit(main())
