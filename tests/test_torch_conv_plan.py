"""Host-side plans of the int8 convolution and the fused block kernels,
checked on the CPU.

The kernels run only on the card. What decides whether the convolution
reads the right input bytes is arithmetic this file repeats with the
kernel's integers: the tile plan (``int8_conv_plan``) at every convolution
the int8 detector launches, and the implicit GEMM's addressing — the row
table, the tap decode of each copy, the zero-fill of padding taps, ragged K
ends and rows beyond M — emulated in PyTorch and held to ``F.unfold`` of the
SAME-padded image and to ``int8_conv_plain``. The detector runner keeps its
kernels K-major, as the kernel reads them. The fused block's shared memory
(``block_smem_bytes``, the layout of ``csrc/fused.cu``) fits every block the
fused runner plans.
"""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepfake_vit_tpu_torch.models import scrfd_int8
from deepfake_vit_tpu_torch.models.fused_backbone import plan_fused_stages
from deepfake_vit_tpu_torch.models.layers import init_weights, same_pads
from deepfake_vit_tpu_torch.ops import fused_stages as fs
from deepfake_vit_tpu_torch.ops import int8_kernel as ik
from deepfake_vit_tpu_torch.ops.cuda_build import SM_COUNT, SMEM_PER_BLOCK
from deepfake_vit_tpu_torch.preprocessing.detector import build_detection_net

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runner():
    """The int8 detector as the serving path builds it (the 2× pool folded
    into the first conv), seeded weights, dynamic scales."""
    det = init_weights(build_detection_net("scrfd", dtype=torch.float32, stem_pool=2), 0).eval()
    return scrfd_int8.ScrfdInt8Runner(det)


@pytest.fixture(scope="module")
def detector_convs(runner, monkeypatch_module):
    """(H, W, Cin, Cout, k, stride) of every int8_conv launch of one detector
    call on the 320² detection canvas (640² before the folded pool)."""
    seen = []
    real = scrfd_int8.int8_conv

    def recording(xq, kq, sx, sw, bias=None, stride=1):
        seen.append((xq.shape[1], xq.shape[2], xq.shape[3], kq.shape[3], kq.shape[0], stride))
        return real(xq, kq, sx, sw, bias, stride)

    monkeypatch_module.setattr(scrfd_int8, "int8_conv", recording)
    runner(torch.zeros((1, 640, 640, 3)))
    monkeypatch_module.undo()
    return seen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_detector_launches_the_twelve_shapes(detector_convs):
    counts = collections.Counter(detector_convs)
    assert len(detector_convs) == 25 and len(counts) == 12
    assert counts[(40, 40, 64, 64, 3, 1)] == 6  # two residual blocks and the 40² head
    assert counts[(160, 160, 32, 32, 3, 2)] == 1  # stem conv 2
    assert {(80, 80, 32, 64, 1, 2), (40, 40, 64, 128, 1, 2), (20, 20, 128, 256, 1, 2)} < set(counts)


@pytest.mark.parametrize("batch", [1, 32, 128])
def test_int8_conv_plan_is_legal_for_the_detector(detector_convs, batch):
    for H, W, cin, cout, k, stride in sorted(set(detector_convs)):
        Ho, Wo = -(-H // stride), -(-W // stride)
        M, K = batch * Ho * Wo, k * k * cin
        p = ik.int8_conv_plan(M, K, cout, cin)
        assert (p.tile_m, p.tile_n) == ik.CONV_TILES[p.config]
        assert p.tile_m % 64 == 0 and p.tile_n % 32 == 0  # whole 64 x 32 warp tiles
        assert p.copy_bytes in (16, 8, 4) and cin % p.copy_bytes == 0 and K % p.copy_bytes == 0
        assert p.copy_bytes == 16  # every detector Cin is a multiple of 16
        assert p.k_padded % 64 == 0 and K <= p.k_padded < K + 64
        assert p.smem_bytes == 3 * (p.tile_m + p.tile_n) * 80 + 16 * p.tile_m <= SMEM_PER_BLOCK
        assert p.blocks == -(-M // p.tile_m) * -(-cout // p.tile_n) < 2 ** 31
        assert (p.tile_n == 32) == (cout <= 32)
        assert (p.tile_m // 64) * (p.tile_n // 32) <= 16  # at most 512 threads a block
        # 128 × 64 only where 256 × 64 tiles leave SMs without a block; 512 × 64
        # for one K step where its tiles do not
        assert (p.config == 2) == (cout > 32 and -(-M // 256) * -(-cout // 64) < SM_COUNT)
        assert (p.config == 3) == (cout > 32 and K <= 64
                                   and -(-M // 512) * -(-cout // 64) >= SM_COUNT)
        if batch == 128:  # every SM has a block but at 10² 64 → 64 (100 blocks of 128 × 64)
            assert p.blocks >= SM_COUNT or (H, cout, p.blocks) == (10, 64, 100)


def _implicit_gemm_a(xq: torch.Tensor, k: int, stride: int, tile_m: int, copy: int,
                     k_padded: int) -> torch.Tensor:
    """The A operand as ``int8_conv_kernel`` stages it: (M rounded up to the
    tile, K rounded up to the 64-byte step) s8, with the kernel's integers —
    the row table (offset of input pixel (hi0, wi0) of image b, hi0, wi0; a
    row beyond M gets hi0 = −2²⁸), one tap decode per copy of ``copy``
    bytes, the unsigned bound checks, zero for a copy that fails them."""
    B, H, W, Cin = xq.shape
    (pt, _), (pl, _) = same_pads(H, k, stride), same_pads(W, k, stride)
    Ho, Wo = -(-H // stride), -(-W // stride)
    M, K = B * Ho * Wo, k * k * Cin
    m = torch.arange(-(-M // tile_m) * tile_m)
    b, rem = m // (Ho * Wo), m % (Ho * Wo)
    hi0, wi0 = (rem // Wo) * stride - pt, (rem % Wo) * stride - pl
    offset = ((b * H + hi0) * W + wi0) * Cin
    inside_m = m < M
    hi0, offset = torch.where(inside_m, hi0, -(1 << 28)), torch.where(inside_m, offset, 0)
    kk = torch.arange(k_padded)
    kc, within = kk // copy * copy, kk % copy  # the copy's first K index, byte in the copy
    tap = kc // Cin
    tr, tc = tap // k, tap % k
    assert bool(((kc % Cin) + copy <= Cin).all()), "a copy stays inside one tap"
    koff = (tr * W + tc) * Cin + kc % Cin
    hi, wi = hi0[:, None] + tr[None], wi0[:, None] + tc[None]
    ok = (kc < K)[None] & (hi >= 0) & (hi < H) & (wi >= 0) & (wi < W)
    idx = (offset[:, None] + koff[None] + within[None]).clamp(0, xq.numel() - 1)
    return torch.where(ok, xq.reshape(-1)[idx], torch.zeros((), dtype=xq.dtype))


@pytest.mark.parametrize("size,cin,k,stride", [
    ((7, 10), 12, 3, 1),   # odd and even sizes, 4-byte copies
    ((8, 9), 4, 3, 2),     # Cin 4: 16 copies a 64-byte K step, 27 taps' bytes ragged
    ((10, 10), 32, 3, 2),  # the detector's case: even size at stride 2 pads (0, 1)
    ((9, 8), 32, 1, 2),    # 1×1 stride-2 shortcut on an odd size
    ((5, 6), 4, 1, 1),     # K = 4: one copy, the rest of the step zero
    ((6, 6), 32, 3, 1),
    ((11, 7), 12, 1, 2),
    ((9, 9), 12, 3, 2),    # odd size at stride 2 pads (1, 1)
])
def test_implicit_gemm_addressing_matches_unfold(size, cin, k, stride):
    """The emulated A operand is the im2col matrix of the SAME-padded image
    in the kernel's K order (tap row, tap column, channel), zero in the
    ragged K step and in the rows that fill the last tile; with the K-major
    kernel it gives ``int8_conv_plain`` bit for bit."""
    H, W = size
    rng = np.random.default_rng(H * W + cin + k)
    B, cout = 3, 20
    xq = torch.from_numpy(rng.integers(-128, 128, (B, H, W, cin)).astype(np.int8))
    kq = torch.from_numpy(rng.integers(-128, 128, (k, k, cin, cout)).astype(np.int8))
    Ho, Wo = -(-H // stride), -(-W // stride)
    M, K = B * Ho * Wo, k * k * cin
    p = ik.int8_conv_plan(M, K, cout, cin)
    assert p.copy_bytes == next(c for c in (16, 8, 4) if cin % c == 0)
    a = _implicit_gemm_a(xq, k, stride, p.tile_m, p.copy_bytes, p.k_padded)
    assert a.shape == (-(-M // p.tile_m) * p.tile_m, p.k_padded)

    (pt, pb), (pl, pr) = same_pads(H, k, stride), same_pads(W, k, stride)
    xp = F.pad(xq.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
    cols = F.unfold(xp, k, stride=stride)  # (B, Cin·k·k, L), K order (c, tr, tc)
    assert cols.shape[2] == Ho * Wo
    want = cols.reshape(B, cin, k, k, -1).permute(0, 4, 2, 3, 1).reshape(M, K)
    assert torch.equal(a[:M, :K].float(), want)
    assert not a[:M, K:].any() and not a[M:].any()

    wt = kq.permute(3, 0, 1, 2).reshape(cout, K)  # the K-major kernel
    sx = torch.from_numpy(rng.uniform(0.01, 0.05, B).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    acc = a[:M, :K].double() @ wt.double().t()
    got = ((acc.float().reshape(B, -1, cout) * sx[:, None, None]) * sw + bias).reshape(
        B, Ho, Wo, cout)
    assert torch.equal(got, ik.int8_conv_plain(xq, kq, sx, sw, bias, stride))


def test_int8_detector_keeps_kernels_k_major(runner):
    """Every quantized kernel of the detector runner is the HWIO view of a
    contiguous (Cout, k, k, Cin) tensor, which the kernel reads without a
    copy, and gives the same result as the same kernel stored HWIO."""
    kqs = [runner.stem2[0], *(e[n][0] for e in runner.blocks for n in ("c1", "c2", "down")
                              if n in e), *(c[0] for c in runner.smooth),
           *(c[0] for c in runner.towers)]
    assert len(kqs) == 21
    for kq in kqs:
        assert kq.permute(3, 0, 1, 2).is_contiguous() and not kq.is_contiguous()
    rng = np.random.default_rng(4)
    kq = kqs[1]
    xq = torch.from_numpy(rng.integers(-128, 128, (2, 9, 9, kq.shape[2])).astype(np.int8))
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, kq.shape[3]).astype(np.float32))
    one = torch.ones(1)
    assert torch.equal(ik.int8_conv(xq, kq, one, sw, None, 2),
                       ik.int8_conv(xq, kq.contiguous(), one, sw, None, 2))


@pytest.mark.parametrize("layout", ["hwio", "k_major", "strided"])
def test_int8_conv_takes_any_kernel_layout(layout):
    """A kernel that is not K-major (HWIO-contiguous, or a strided slice)
    gives the same plain result as the K-major copy the kernel reads."""
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-128, 128, (2, 6, 7, 12)).astype(np.int8))
    base = torch.from_numpy(rng.integers(-128, 128, (3, 3, 12, 16)).astype(np.int8))
    kq = {"hwio": base, "k_major": scrfd_int8._k_major(base),
          "strided": torch.stack([base, base], 4)[..., 0]}[layout]
    assert torch.equal(kq, base)
    sx = torch.from_numpy(rng.uniform(0.01, 0.05, 2).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, 16).astype(np.float32))
    assert torch.equal(ik.int8_conv(xq, kq, sx, sw, None, 1),
                       ik.int8_conv_plain(xq, base, sx, sw, None, 1))


@pytest.mark.parametrize("size", [192, 224])
@pytest.mark.parametrize("variant", ["b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7"])
def test_block_smem_fits_every_planned_block(variant, size):
    """Pass 2 of every block the fused runner plans fits one block's shared
    memory (b7's widest at 224²: 146,896 bytes), two blocks an SM for every
    block of B4 and below at 192²."""
    plans, _ = plan_fused_stages(variant, size)
    bps = [bp for plan, _ in plans for bp in plan.blocks]
    assert bps
    for bp in bps:
        fs.check_plan("run_block", bp)  # raises on more than a block's shared memory
        need = fs.block_smem_bytes(bp)
        assert need <= SMEM_PER_BLOCK
        if size == 192 and variant <= "b4":
            assert 2 * (need + 1024) <= 233472  # the SM's 228 KB, 1 KB reserved a block
