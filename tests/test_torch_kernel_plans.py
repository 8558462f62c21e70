"""Host-side plans of the crop and GEMM kernels, checked on the CPU.

The kernels run only on the card; what decides whether they read every
pixel and weight they need is arithmetic that this file repeats in float32
with the kernels' operation order: the column span and the source rows the
crop kernel stages, its passes over a band, the shared memory each plan
asks for, and the GEMM's tile for every product of the int8 tail.
"""

import numpy as np
import pytest
import torch

from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone, block_args
from deepfake_vit_tpu_torch.models.int8_tail import Int8TailRunner
from deepfake_vit_tpu_torch.models.layers import init_weights
from deepfake_vit_tpu_torch.ops import int8_kernel as ik
from deepfake_vit_tpu_torch.ops import warp_kernel as wk
from deepfake_vit_tpu_torch.ops.cuda_build import SMEM_PER_BLOCK
from deepfake_vit_tpu_torch.ops.warp import frac_window_levels, window_geometry_frac

torch.set_num_threads(1)

WINDOW, FACE, C = 128, (192, 192), 3


def _geometry(n, H, W, seed):
    """Seeded dst→src similarities from quads well inside a window (r = 1)
    to quads larger than the frame (the top strip bucket, r > H/window)."""
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(np.log(0.3), np.log(1.5 * max(H, W) / FACE[0]), n))
    s[: n // 8] = 0.4
    th = rng.uniform(-0.35, 0.35, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    center = np.stack([rng.uniform(-40, W + 40, n), rng.uniform(-40, H + 40, n)], -1)
    t = center - np.einsum("nij,j->ni", R, np.asarray([(FACE[1] - 1) / 2, (FACE[0] - 1) / 2]))
    A = torch.as_tensor(np.concatenate([R, t[..., None]], -1), dtype=torch.float32)
    levels = frac_window_levels(H, WINDOW)
    level, strip0s, r, off_y, x0f, _ = window_geometry_frac(A, FACE, (H, W), WINDOW, levels,
                                                            y_align=16)
    strip0 = strip0s[level.long(), torch.arange(n)]
    assert set(level.tolist()) == set(range(levels)), "every strip bucket"
    return levels, strip0, level, r, off_y, x0f


def _coord(off, i, r):
    """window_coord: off + (i + 0.5)·r − 0.5 in float32, left to right."""
    return off[:, None] + (i + 0.5) * r[:, None] - 0.5


def _taps(s, t, rank1):
    """The kernels' tap weight of integer tap t for coordinate s, as float32."""
    if rank1:
        return (1.0 - ((s + (1 - t).float()) - 1.0).abs()).clamp_min(0.0).to(torch.bfloat16).float()
    return (1.0 - (s - t.float()).abs()).clamp_min(0.0).to(torch.bfloat16).float()


def _kernel_column_span(r, x0f, W):
    """[c_lo, c_hi] of crop_frac_band_kernel, from the first and last
    output columns' coordinates (empty: c_hi < c_lo)."""
    ends = torch.tensor([0.0, WINDOW - 1.0])
    sx = _coord(x0f, ends, r)
    first, last = sx[:, 0], sx[:, 1]
    some = (last > -1.0) & (first < W)
    c_lo = torch.floor(first.clamp_min(-1.0)).long().clamp_min(0)
    c_hi = (torch.floor(last.clamp_max(float(W))).long() + 1).clamp_max(W - 1)
    return torch.where(some, c_lo, 0), torch.where(some, c_hi, -1)


def _kernel_passes(t0, w, nrows, max_slots):
    """The kernel's passes over one band: the band rows of each pass and the
    source rows of its slots, each row once (rows are nondecreasing)."""
    passes, i0 = [], 0
    while i0 < nrows:
        slots, i = [], i0
        while i < nrows:
            fresh = []
            for k in (0, 1):
                row = int(t0[i]) + k
                if w[i][k] != 0.0 and row != (fresh or slots or [None])[-1]:
                    fresh.append(row)
            if len(slots) + len(fresh) > max_slots:
                break
            slots += fresh
            i += 1
        assert i > i0, "a pass takes at least one band row"
        passes.append((range(i0, i), slots))
        i0 = i
    return passes


@pytest.mark.parametrize("construction", ["legacy", "mxu"])
@pytest.mark.parametrize("H,W", [(640, 640), (1088, 1920)])
def test_crop_frac_plan_covers_every_tap(H, W, construction):
    """Every tap that crop_frac_plain reads with a nonzero weight lies in the
    column span and among the source rows the kernel stages, in the pass
    that computes its output row; every pass fits the plan's slots and the
    plan's shared memory fits a block (1088 rows: a 1080-row frame padded
    to the 16-row strip alignment, as warp_affine_windowed pads it)."""
    rank1 = construction == "mxu"
    levels, strip0, level, r, off_y, x0f = _geometry(48, H, W, seed=H + W)
    plan = wk.crop_frac_plan(WINDOW, C, W)
    assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.slot_budget >= 2 * plan.slot_bytes
    assert plan.smem_bytes == plan.slot_budget + 12 * WINDOW + 36 * plan.band
    assert float(r.max()) > H / WINDOW  # the largest r: a quad larger than the frame

    i = torch.arange(WINDOW, dtype=torch.float32)
    sx, sy = _coord(x0f, i, r), _coord(off_y, i, r)
    c_lo, c_hi = _kernel_column_span(r, x0f, W)
    rows = torch.clamp_max(torch.full_like(level.long(), WINDOW) << level.long(), H)

    # Columns: the plain version's nonzero horizontal taps.
    for dx in (0, 1):
        s = torch.floor(sx).long() + dx
        hit = (s >= 0) & (s < W) & (_taps(sx, s, rank1) > 0)
        assert ((s >= c_lo[:, None]) & (s <= c_hi[:, None]) | ~hit).all()
    span = torch.where(c_hi >= c_lo, (c_hi - c_lo + 1) * C * 2, 0)
    stride = torch.where(span > 0, ((span + 15) // 16 + 1) * 16, 0)
    assert int(span.max()) == W * C * 2 and int(stride.max()) <= plan.slot_bytes

    # Rows: the plain version's nonzero vertical taps, pass by pass.
    t0 = torch.floor(sy).long()
    weights = []
    for dy in (0, 1):
        t = t0 + dy
        ok = ((sy > -1.0) & (sy < rows[:, None].float()) & (t >= 0) & (t < rows[:, None])
              & (strip0[:, None] + t >= 0) & (strip0[:, None] + t < H))
        u = (t.float() + (1.0 - sy)) - 1.0 if rank1 else sy - t.float()
        weights.append((1.0 - u.abs()).clamp_min(0.0).to(torch.bfloat16).float() * ok)
    for n in range(strip0.shape[0]):
        st = int(stride[n])
        max_slots = min(2 * plan.band, plan.slot_budget // st) if st else 2 * plan.band
        assert max_slots >= 2
        for o0 in range(0, WINDOW, plan.band):
            nrows = min(plan.band, WINDOW - o0)
            w = [(float(weights[0][n, o0 + k]), float(weights[1][n, o0 + k])) for k in range(nrows)]
            for band_rows, slots in _kernel_passes(t0[n, o0:o0 + nrows], w, nrows, max_slots):
                assert len(slots) <= max_slots and slots == sorted(set(slots))
                for k in band_rows:
                    for dy in (0, 1):
                        if w[k][dy] != 0.0:
                            assert int(t0[n, o0 + k]) + dy in slots


@pytest.mark.parametrize("construction", ["legacy", "mxu"])
def test_crop_frac_takes_the_geometry_types(construction):
    """The wrappers take the geometry's own float32 r, off_y and x0f (and
    frame_idx None), which the kernel reads as they are: r is on the 2⁻¹⁶
    grid and at most 2⁸, so rfp·2⁻¹⁶ == r exactly in float32, and the
    offsets are integers. The CPU result equals the plain version on the
    int32 forms bit for bit."""
    H = W = 256
    window = 64
    rng = np.random.default_rng(7)
    n = 16
    s = np.exp(rng.uniform(np.log(0.2), np.log(2.5), n))
    s[:3] = 0.25
    th = rng.uniform(-0.3, 0.3, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    t = rng.uniform(-20, W + 20, (n, 2)) - np.einsum("nij,j->ni", R, np.asarray([23.5, 23.5]))
    A = torch.as_tensor(np.concatenate([R, t[..., None]], -1), dtype=torch.float32)
    level, strip0s, r, off_y, x0f, _ = window_geometry_frac(
        A, (48, 48), (H, W), window, frac_window_levels(H, window), y_align=16)
    strip0 = strip0s[level.long(), torch.arange(n)]
    assert r.dtype == off_y.dtype == x0f.dtype == torch.float32
    assert strip0.dtype == level.dtype == torch.int32
    rfp = torch.round(r * 65536.0).to(torch.int32)
    assert torch.equal(rfp.float() * (1.0 / 65536.0), r) and float(r.max()) <= 2.0 ** 8
    assert torch.equal(off_y, torch.floor(off_y)) and torch.equal(x0f, torch.floor(x0f))
    assert (r == 1.0).any() and (r > 1.0).any()

    frames = torch.from_numpy(rng.uniform(0, 255, (n, H, W * C)).astype(np.float32)).to(torch.bfloat16)
    fn = wk.crop_frac if construction == "legacy" else wk.crop_frac_mxu
    got = fn(frames, strip0, level, r, off_y, x0f, window, C)
    want = wk.crop_frac_plain(frames, strip0, level, rfp, off_y.int(), x0f.int(), window, C,
                              torch.arange(n, dtype=torch.int32), construction)
    assert torch.equal(got, want)


def _tail_gemm_shapes(face: int, batch: int, start: int = 10):
    """(M, K, N) of every int8 GEMM of B4's tail from block ``start`` at
    ``face``² inputs: expand at the block's input size, project at its
    output size."""
    shapes = []
    h = face // 2  # after the stride-2 stem
    for idx, a in enumerate(block_args("b4")):
        cexp = a["in_filters"] * a["expand_ratio"]
        ho = -(-h // a["stride"])
        if idx >= start:
            if a["expand_ratio"] != 1:
                shapes.append((batch * h * h, a["in_filters"], cexp))
            shapes.append((batch * ho * ho, cexp, a["out_filters"]))
        h = ho
    return shapes


@pytest.mark.parametrize("face", [192, 224])
@pytest.mark.parametrize("batch", [32, 128])
def test_int8_gemm_plan_is_legal_for_the_tail(face, batch):
    shapes = _tail_gemm_shapes(face, batch)
    assert len(shapes) == 44  # 22 blocks from block 10, each expands and projects
    for M, K, N in shapes:
        p = ik.int8_gemm_plan(M, K, N)
        assert K % 4 == 0 and N % 4 == 0
        assert (p.tile_m, p.tile_n) == ik.GEMM_TILES[p.config]
        assert p.tile_m % 64 == 0 and p.tile_n % 32 == 0  # whole 64 x 32 warp tiles
        assert p.copy_bytes in (16, 8, 4) and K % p.copy_bytes == 0
        assert p.k_padded % 64 == 0 and K <= p.k_padded < K + 64  # whole k32 steps
        assert p.smem_bytes == 3 * (p.tile_m + p.tile_n) * 80 <= SMEM_PER_BLOCK
        assert p.blocks == -(-M // p.tile_m) * -(-N // p.tile_n)
        assert -(-M // p.tile_m) <= 65535
    if (face, batch) == (192, 128):  # the shapes chip_smoke.py measures
        assert {(73728, 56, 336), (18432, 160, 960), (4608, 2688, 448)} <= set(shapes)
        plan = ik.int8_gemm_plan(4608, 2688, 448)
        assert (plan.tile_m, plan.tile_n, plan.copy_bytes) == (128, 64, 16)
        assert ik.int8_gemm_plan(73728, 56, 336).copy_bytes == 8  # 56-byte rows


def test_int8_tail_keeps_weights_k_major():
    """The runner's GEMM weights are (K, N) views of contiguous (N, K)
    tensors, which the kernel reads without a copy, and give the same
    product as row-major weights."""
    bb = init_weights(EfficientNetBackbone("b0"), 0).eval()
    runner = Int8TailRunner(bb, start_block=14)
    wq = [e[name][0] for e in runner.blocks for name in ("exp", "proj") if name in e]
    assert wq and all(w.t().is_contiguous() and not w.is_contiguous() for w in wq)
    rng = np.random.default_rng(3)
    w = wq[0]
    xq = torch.from_numpy(rng.integers(-128, 128, (40, w.shape[0])).astype(np.int8))
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, w.shape[1]).astype(np.float32))
    one = torch.ones(1)
    assert torch.equal(ik.int8_gemm(xq, w, one, sw), ik.int8_gemm(xq, w.contiguous(), one, sw))
