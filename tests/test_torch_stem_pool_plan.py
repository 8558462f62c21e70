"""Host-side plans and addressing of the stem and pooled-crop kernels,
checked on the CPU.

The kernels run only on the card. What decides whether they read the right
values is integer arithmetic this file repeats with the kernels' own
formulas (``csrc/fused.cu::fused_stem_kernel``,
``csrc/warp.cu::crop_pool_band_kernel``):

- the stem's plan (``stem_plan``), its staged input rows (zero past the
  bottom and right edges, copied in 16- or 4-byte units) and its
  A-fragment addressing (K padded to 32: three runs of 9 values per tap row
  dy at columns 10·dy, one masked half at off 8), held to the patches of
  ``run_stem_plain`` exactly, and the product to ``run_stem_plain``;
- the pooled crop's plan (``crop_pool_plan``), the 16-byte-aligned span each
  staged row copies, the stages of a band (a power of two of rows, f32 sums
  carried across stages when an output row's rows outnumber a stage) and
  the in-place vertical and the horizontal passes, held to
  ``crop_pool_plain`` bit for bit on integer-valued frames.
"""

import numpy as np
import pytest
import torch

from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
from deepfake_vit_tpu_torch.models.layers import init_weights
from deepfake_vit_tpu_torch.ops import fused_stages as fs
from deepfake_vit_tpu_torch.ops import warp_kernel as wk
from deepfake_vit_tpu_torch.ops.cuda_build import SMEM_PER_BLOCK
from deepfake_vit_tpu_torch.ops.warp import max_window_levels

torch.set_num_threads(1)

FUSED_TOL = 2.0 ** -7  # chip_smoke.py's limit for the fused kernels


# ---------------------------------------------------------------------------
# Stem
# ---------------------------------------------------------------------------


def _stem_k_columns():
    """(index into the 27 patch values or -1, dy, off) for K column
    c = 0..31 as the kernel builds its fragments: the pair c - c % 2 =
    16s + 8h + 2·t4 reads elements off, off + 1 of tap row dy, with
    dy = pair // 10 and off = pair % 10; a pair at off 8 keeps its low half
    only, c ≥ 30 is zero."""
    cols = []
    for c in range(32):
        pair = c - c % 2
        dy, off = pair // 10, pair % 10 + c % 2
        keep = dy < 3 and not (pair % 10 == 8 and c % 2)
        cols.append((dy * 9 + off if keep else -1, dy, off))
    return cols


def _stem_staged_rows(x_u16, bi, y0, x0, plan, H, W):
    """The block's staged input rows (2·rows + 1, row_stride) uint16, as the
    kernel's copies fill them: image row 2·y0 + r from element 6·x0 on, the
    bytes on the image (valid_b) copied in copy_bytes units, the rest and
    every row at or past H zero."""
    rs = plan.row_stride
    rowb, col0b = W * 6, x0 * 12
    valid_b = min(rs * 2, rowb - col0b)
    cw = plan.copy_bytes
    assert valid_b % 4 == 0 and (rs * 2) % cw == 0
    staged = np.zeros((2 * plan.rows + 1, rs), np.uint16)
    for r in range(2 * plan.rows + 1):
        iy = 2 * y0 + r
        for off in range(0, rs * 2, cw):
            nb = min(cw, max(0, valid_b - off)) if iy < H else 0
            if nb:
                assert ((bi * H + iy) * rowb + col0b + off) % cw == 0, "aligned copy"
                src = x_u16[bi, iy].reshape(-1)
                lo = (col0b + off) // 2
                staged[r, off // 2:(off + nb) // 2] = src[lo:lo + nb // 2]
    return staged


def _stem_a_matrix(staged, plan, wc, nrows):
    """The A operand of the block, (pixels, 32) as uint16 bit patterns, from
    the kernel's fragment addressing: pixel p = (yl, xo) at element
    2·yl·rs + 6·xo, column c at dy·rs + off, 32-bit loads masked."""
    rs = plan.row_stride
    flat = staged.reshape(-1)
    p = np.arange(nrows * wc)
    base = 2 * (p // wc) * rs + 6 * (p % wc)
    A = np.zeros((p.size, 32), np.uint16)
    for c, (idx, dy, off) in enumerate(_stem_k_columns()):
        if idx < 0:
            continue
        addr = base + dy * rs + off
        assert addr.max() < flat.size
        A[:, c] = flat[addr]
    return A


def _plain_patches(x):
    """run_stem_plain's patch matrix (B, H/2, W/2, 27) in float32."""
    B, H, W, _ = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 1, 0, 1))
    return torch.cat([xp[:, dy:dy + H:2, dx:dx + W:2, :] for dy in range(3) for dx in range(3)],
                     dim=-1)


@pytest.mark.parametrize("H,W,cstem", [(192, 192, 48), (224, 224, 48), (20, 12, 32),
                                       (10, 212, 48), (18, 300, 64), (6, 520, 56)])
def test_stem_plan_is_legal(H, W, cstem):
    """The work items (band × segment) tile every output pixel once, a
    staged row holds the segment's 2·seg + 2 input pixels, the copies are
    aligned, and two input buffers and the output fit a block's shared
    memory."""
    plan = fs.stem_plan(H, W, cstem)
    Ho, Wo = H // 2, W // 2
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes == (2 * (2 * plan.rows + 1) * plan.row_stride * 2
                               + plan.rows * plan.seg * (cstem + 8) * 2)
    assert plan.row_stride % 8 == 0 and plan.row_stride >= 6 * plan.seg + 6
    assert plan.copy_bytes == (16 if W % 8 == 0 else 4)
    assert plan.seg == Wo or plan.seg % 4 == 0  # a segment starts on a 16-byte boundary
    covered = np.zeros((Ho, Wo), np.int32)
    bands, segs = -(-Ho // plan.rows), -(-Wo // plan.seg)
    assert plan.items == bands * segs
    for band in range(bands):
        for sg in range(segs):
            y0, x0 = band * plan.rows, sg * plan.seg
            covered[y0:y0 + min(plan.rows, Ho - y0), x0:x0 + min(plan.seg, Wo - x0)] += 1
    assert (covered == 1).all()
    if (H, W) in ((192, 192), (224, 224)):
        assert plan.seg == Wo and plan.rows == 2 and plan.copy_bytes == 16


@pytest.mark.parametrize("variant,shape", [("b4", (2, 192, 192, 3)), ("b4", (1, 224, 224, 3)),
                                           ("b4", (2, 10, 212, 3)), ("b0", (2, 20, 12, 3)),
                                           ("b7", (1, 18, 300, 3))])
def test_stem_fragment_addressing_reproduces_plain(variant, shape):
    """Staged rows and A fragments, with the kernel's integers, give exactly
    run_stem_plain's patches (the zero row past the bottom edge and the zero
    column past the right edge included); the B fragments put the folded
    weights at the same columns, so A·Bᵀ in float64 is the plain product,
    and bf16(silu(A·Bᵀ + b)) is run_stem_plain within the fused limit."""
    bb = init_weights(EfficientNetBackbone(variant), 5).eval()
    w, b = fs.fold_stem_weights(bb)
    cstem = w.shape[0]
    g = torch.Generator().manual_seed(shape[2])
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    B, H, W, _ = shape
    Ho, Wo = H // 2, W // 2
    plan = fs.stem_plan(H, W, cstem)
    x_u16 = x.view(torch.int16).numpy().view(np.uint16)
    patches = _plain_patches(x)  # (B, Ho, Wo, 27)
    plain = fs.run_stem_plain(x, (w, b)).float()

    cols = _stem_k_columns()
    w_u16 = w.view(torch.int16).numpy().view(np.uint16)
    Bm = np.zeros((cstem, 32), np.uint16)  # the B fragments' columns
    for c, (idx, _, _) in enumerate(cols):
        if idx >= 0:
            Bm[:, c] = w_u16[:, idx]
    Bf = torch.from_numpy(Bm.view(np.int16)).view(torch.bfloat16).double()

    got = torch.zeros((B, Ho, Wo, cstem))
    for bi in range(B):
        for y0 in range(0, Ho, plan.rows):
            for x0 in range(0, Wo, plan.seg):
                nrows, wc = min(plan.rows, Ho - y0), min(plan.seg, Wo - x0)
                staged = _stem_staged_rows(x_u16, bi, y0, x0, plan, H, W)
                A = _stem_a_matrix(staged, plan, wc, nrows)
                Af = torch.from_numpy(A.view(np.int16)).view(torch.bfloat16).float()
                want = patches[bi, y0:y0 + nrows, x0:x0 + wc].reshape(-1, 27)
                for c, (idx, _, _) in enumerate(cols):
                    col = want[:, idx] if idx >= 0 else torch.zeros(want.shape[0])
                    assert torch.equal(Af[:, c], col), (bi, y0, x0, c)
                prod = Af.double() @ Bf.t()
                assert torch.equal(prod, want.double() @ w.double().t())
                out = torch.nn.functional.silu((prod.float() + b)).to(torch.bfloat16).float()
                got[bi, y0:y0 + nrows, x0:x0 + wc] = out.reshape(nrows, wc, cstem)
    diff = (got - plain).abs()
    assert (diff <= FUSED_TOL * plain.abs().clamp_min(1.0)).all()


# ---------------------------------------------------------------------------
# Pooled crop
# ---------------------------------------------------------------------------


def _pool_stage_rows(plan, span, side, total):
    """Rows of a stage, as the kernel chooses them: a power of two, doubled
    while two stages' worth fit the stage buffer, at most out_rows output
    rows, never past the band."""
    nch = (span * 2 + 15) // 16 + 1 if span > 0 else 0
    slot = 16 * max(nch, 1)
    rs = 1
    while 2 * rs * slot <= plan.stage_bytes and 2 * rs <= side * plan.out_rows and 2 * rs <= total:
        rs *= 2
    return nch, slot, rs


def _replica_crop_pool(frames, y0_l0, x0s, level, fidx, window, C, plan):
    """crop_pool_band_kernel with the kernel's integers, in numpy: the
    frames as one flat 16-byte-aligned uint16 array; per face and band the
    stages, each staged row's 16-byte chunks of the aligned superset of its
    span (zero-filled past the array's end), the vertical pass (16-byte
    chunks at a shared phase when W·C % 8 == 0, else per element at each
    row's phase) writing t1 over the output row's first slot, the f32 carry,
    and the horizontal pass over the frame's columns."""
    Bf, H, WC = frames.shape
    W = WC // C
    flat = frames.view(torch.int16).numpy().view(np.uint16).reshape(-1)
    pad = np.concatenate([flat, np.zeros(16, np.uint16)])  # zeros past the end (zfill)
    vec = WC % 8 == 0
    N = y0_l0.shape[0]
    out = np.zeros((N, window, window * C), np.float32)

    def bf16(a):
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return t.to(torch.bfloat16).float().numpy()

    def as_f32(u16):
        return (u16.astype(np.uint32) << 16).view(np.float32)

    for n in range(N):
        l = int(level[n])
        side, inv = 1 << l, np.float32(2.0 ** -l)
        fi, x0 = int(fidx[n]), int(x0s[n])
        cv_lo, cv_hi = max(x0 << l, 0), min((x0 + window) << l, W)
        span = (cv_hi - cv_lo) * C if cv_hi > cv_lo else 0
        for o0 in range(0, window, plan.band):
            nrows = min(plan.band, window - o0)
            ybase = int(y0_l0[n]) + (o0 << l)
            total = nrows * side
            nch, slot, rs = _pool_stage_rows(plan, span, side, total)
            assert rs * slot <= plan.stage_bytes and slot <= plan.slot_bytes
            ne = slot // 2  # elements of a slot

            def phase(y):
                return (((fi * H + y) * WC + cv_lo * C) & 0xffffffff) & 7

            carry = np.zeros(ne, np.float32)
            n_stages = -(-total // rs)
            for s in range(n_stages):
                k0, k1 = s * rs, min(s * rs + rs, total)
                n_out = max(1, (k1 - k0) >> l)
                rows_per_out = min(rs, side)
                first, last = k0 % side == 0, k1 % side == 0
                buf = np.full((rs, ne), 0x7fc0, np.uint16)  # stale slots read as NaN
                for i in range(k1 - k0):
                    y = ybase + k0 + i
                    if y < 0 or y >= H or nch == 0:
                        continue
                    begin = (fi * H + y) * WC + cv_lo * C
                    a = begin & ~7
                    q = np.arange(nch)[a + 8 * np.arange(nch) < begin + span]  # chunks copied
                    buf[i].reshape(-1, 8)[q] = pad[a + 8 * q[:, None] + np.arange(8)]
                t1_rows = []
                for oi in range(n_out):
                    i0 = oi * rows_per_out
                    yf = ybase + k0 + i0
                    if vec:
                        assert all(phase(yf + r) == phase(yf) for r in range(rows_per_out))
                        v = np.zeros(8 * nch, np.float32) if first else carry[:8 * nch].copy()
                        for r in range(rows_per_out):
                            if 0 <= yf + r < H:
                                v = v + as_f32(buf[i0 + r, :8 * nch])
                        if last:
                            t1 = bf16(v * inv)
                            buf[i0, :8 * nch] = (t1.view(np.uint32) >> 16).astype(np.uint16)
                        else:
                            carry[:8 * nch] = v
                    else:
                        v = np.zeros(span, np.float32) if first else carry[:span].copy()
                        for r in range(rows_per_out):
                            y = yf + r
                            if 0 <= y < H:
                                v = v + as_f32(buf[i0 + r, phase(y):phase(y) + span])
                        if last:
                            t1 = bf16(v * inv)
                            buf[i0, phase(yf):phase(yf) + span] = (
                                t1.view(np.uint32) >> 16).astype(np.uint16)
                        else:
                            carry[:span] = v
                    t1_rows.append((i0, yf))
                if not last:
                    continue
                e = np.arange(window * C)
                j, c = e // C, e % C
                col0 = (x0 + j) << l
                for oi, (i0, yf) in enumerate(t1_rows):
                    t1 = as_f32(buf[i0])
                    acc = np.zeros(window * C, np.float32)
                    for sc in range(side):
                        col = col0 + sc
                        ok = (col >= cv_lo) & (col < cv_hi)
                        idx = np.where(ok, phase(yf) + (col - cv_lo) * C + c, 0)
                        acc = acc + np.where(ok, t1[idx], np.float32(0))
                    out[n, o0 + (k0 >> l) + oi] = bf16(acc * inv)
    return torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("window", [32, 64, 160])
@pytest.mark.parametrize("width", [640, 1920, 642])
def test_crop_pool_plan_covers_every_column(window, width):
    """At levels 0-2 and at every residue of x0·2ˡ·C·2 mod 16, also with x0
    partly outside the frame: the aligned superset a row stages covers every
    column the face reads on the frame, a slot fits the plan's slot and a
    stage its buffer, and the shared memory fits a block."""
    C = 3
    plan = wk.crop_pool_plan(window, C, width)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes == (2 * plan.stage_bytes + 2 * plan.slot_bytes
                               + plan.out_rows * window * C * 2)
    assert plan.stage_bytes >= plan.slot_bytes and plan.band == min(8, window)
    residues = set()
    for l in range(3):
        side = 1 << l
        for x0 in list(range(-(window // 2), 16)) + list(range((width >> l) - window - 8,
                                                                 (width >> l) + 4)):
            cv_lo, cv_hi = max(x0 << l, 0), min((x0 + window) << l, width)
            span = (cv_hi - cv_lo) * C if cv_hi > cv_lo else 0
            for fy in (0, 1, 7):  # row offsets of the frames array (elements)
                begin = fy * width * C + cv_lo * C
                a = begin & ~7
                nch, slot, rs = _pool_stage_rows(plan, span, side, plan.band * side)
                assert slot <= plan.slot_bytes and rs * slot <= plan.stage_bytes and rs >= 1
                if span == 0:
                    continue
                residues.add((begin * 2) % 16)
                last_chunk = max(q for q in range(nch) if a + 8 * q < begin + span)
                assert a <= begin and a + 8 * (last_chunk + 1) >= begin + span
                assert begin - a == ((begin & 0xffffffff) & 7)  # the kernel's phase
                # Every column a face reads on the frame lies in the span.
                cols = ((x0 + np.arange(window))[:, None] << l) + np.arange(side)
                on = cols[(cols >= 0) & (cols < width)]
                assert on.size == 0 or (on.min() >= cv_lo and on.max() < cv_hi)
    assert residues == set(range(0, 16, 2))


def _pool_faces(n, H, W, window, seed):
    """Seeded per-face scalars as window_geometry makes them (int32 level,
    level-0 row offset, selected-level column offset), every usable level,
    windows reaching past every edge of the frame."""
    rng = np.random.default_rng(seed)
    levels = max_window_levels((H, W), window)
    level = np.arange(n) % levels
    y0 = np.asarray([rng.integers(-window // 2, (H >> l) - window // 2 + 1) for l in level])
    x0 = np.asarray([rng.integers(-window // 2, (W >> l) - window // 2 + 1) for l in level])
    y0[:2], x0[2:4] = -(window // 3), (W >> level[2:4]) - window // 3
    as32 = lambda a: torch.as_tensor(a, dtype=torch.int32)
    return as32(y0 << level), as32(x0), as32(level)


@pytest.mark.parametrize("H,W,window,shared", [(128, 192, 32, False), (160, 644, 32, True),
                                               (256, 1920, 64, False)])
def test_crop_pool_replica_matches_plain(H, W, window, shared):
    """Seeded geometry (every level, windows reaching past every edge of
    the frame), integer-valued frames, shared frames: the replica of the
    kernel's staging and passes equals crop_pool_plain bit for bit. W = 644
    takes the per-element path (W·C % 8 == 4: rows differ in phase)."""
    C, n = 3, 12
    y0_l0, x0, level = _pool_faces(n, H, W, window, seed=W)
    assert set(level.tolist()) == set(range(max_window_levels((H, W), window))) == {0, 1, 2}
    assert (y0_l0 < 0).any() and ((x0 + window) << level > W).any()
    n_frames = 4 if shared else n
    fidx = torch.arange(n, dtype=torch.int32) % n_frames
    frames = torch.from_numpy(np.random.default_rng(H).integers(
        0, 256, (n_frames, H, W * C)).astype(np.float32)).to(torch.bfloat16)
    plan = wk.crop_pool_plan(window, C, W)
    got = _replica_crop_pool(frames, y0_l0, x0, level, fidx, window, C, plan)
    want = wk.crop_pool_plain(frames, y0_l0.int(), x0.int(), level.int(), window, C, fidx)
    assert torch.equal(got, want)


@pytest.mark.parametrize("l", [3, 4])
def test_crop_pool_replica_deep_levels_carry(l):
    """Levels past the geometry's (the wrapper takes any level): 2ˡ rows an
    output row, more than a stage holds, so the f32 sums carry across
    stages; windows partly and wholly outside the frame."""
    H, W, C, window = 96, 640, 3, 64
    y0_l0 = torch.tensor([0, -40, 8 << l, 90, -(window << l)], dtype=torch.int32)
    x0 = torch.tensor([0, -3, 5, (W >> l) - 9, 2], dtype=torch.int32)
    level = torch.full((5,), l, dtype=torch.int32)
    fidx = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int32)
    frames = torch.from_numpy(np.random.default_rng(l).integers(
        0, 256, (2, H, W * C)).astype(np.float32)).to(torch.bfloat16)
    plan = wk.crop_pool_plan(window, C, W)
    span = min(window << l, W) * C
    _, _, rs = _pool_stage_rows(plan, span, 1 << l, plan.band << l)
    assert rs < 1 << l  # an output row spans stages
    got = _replica_crop_pool(frames, y0_l0, x0, level, fidx, window, C, plan)
    want = wk.crop_pool_plain(frames, y0_l0, x0, level, window, C, fidx)
    assert torch.equal(got, want)
    assert not got[4].float().any()  # wholly above the frame


def test_crop_pool_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        wk.crop_pool_plan(160, 3, 40000)
