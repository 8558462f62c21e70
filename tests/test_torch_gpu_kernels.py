"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU: ``pytest -m gpu tests/test_torch_gpu_kernels.py``.
Without one every test skips. The warp and int8 kernels apply their plain
versions' rounding points and exact sums, so they must agree bit for bit.
The fused stem / MBConv kernels sum in another order than their plain
versions and take ``expf`` where those take ``torch.sigmoid``: they agree
within two bf16 steps of the value, ``|k − p| ≤ 2⁻⁷ · max(|p|, 1)``.
"""

import numpy as np
import pytest
import torch

from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone, MBConvBlock, block_args
from deepfake_vit_tpu_torch.models.layers import BatchNorm, init_weights
from deepfake_vit_tpu_torch.ops import fused_mbconv as fm
from deepfake_vit_tpu_torch.ops import fused_stages as fs
from deepfake_vit_tpu_torch.ops import int8_kernel as ik
from deepfake_vit_tpu_torch.ops import warp_kernel as wk
from deepfake_vit_tpu_torch.ops.warp import (frac_window_levels, max_window_levels,
                                             window_geometry, window_geometry_frac)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    wk.build_library()
    return torch.device("cuda")


def _affines(n, H, W, out, dev, seed=0):
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(np.log(0.3), np.log(3.6), n))
    s[: n // 4] = 0.4
    th = rng.uniform(-0.35, 0.35, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    center = rng.uniform(-40, max(H, W) + 40, (n, 2))
    t = center - np.einsum("nij,j->ni", R, np.asarray([(out[1] - 1) / 2, (out[0] - 1) / 2]))
    return torch.as_tensor(np.concatenate([R, t[..., None]], -1), dtype=torch.float32, device=dev)


def _faces(n, H, W, window, out, dev, seed=0):
    A = _affines(n, H, W, out, dev, seed)
    return window_geometry_frac(A, out, (H, W), window, frac_window_levels(H, window), y_align=16)


def _plain_crop(frames, strip0, level, r, off_y, x0f, window, fidx, construction):
    """crop_frac_plain on the int32 forms of the geometry, 3 channels."""
    return wk.crop_frac_plain(frames, strip0.int(), level.int(), torch.round(r * 65536).int(),
                              off_y.int(), x0f.int(), window, 3, fidx.int(), construction)


@pytest.mark.parametrize("shared_frames", [False, True])
def test_crop_frac_kernel_matches_plain(dev, shared_frames):
    """One frame a face with frame_idx None (the identity), or 96 faces on
    8 frames; the geometry's own float32 r, off_y and x0f go in as they are."""
    H, W, C, window, out, N = 640, 640, 3, 128, (192, 192), 96
    level, strip0s, r, off_y, x0f, _ = _faces(N, H, W, window, out, dev)
    strip0 = strip0s[level.long(), torch.arange(N, device=dev)]
    B = 8 if shared_frames else N
    frames = torch.randint(0, 256, (B, H, W * C), device=dev).to(torch.bfloat16)
    fidx = torch.arange(N, device=dev) % B
    before = wk.crop_frac.launches
    got = wk.crop_frac(frames, strip0, level, r, off_y, x0f, window, C,
                       frame_idx=fidx if shared_frames else None)
    torch.cuda.synchronize()
    assert wk.crop_frac.launches == before + 1
    assert torch.equal(got, _plain_crop(frames, strip0, level, r, off_y, x0f, window, fidx,
                                        "legacy"))


@pytest.mark.parametrize("construction", ["legacy", "mxu"])
def test_crop_frac_kernel_edges_and_buckets(dev, construction):
    """Every strip bucket, the whole-frame bucket at r of about 5 and more
    (quads larger than the frame), faces at the frame's left, right, top and
    bottom edges and past them, r = 1 windows copied exactly; general bf16
    pixels; one launch a call, and nothing else on the device."""
    H, W, C, window, out = 640, 640, 3, 128, (192, 192)
    cases = [(x, y, s) for s in (0.4, 0.9, 1.6, 2.7, 3.3, 4.5) for x, y in
             ((4, 320), (636, 320), (320, 636), (320, 3), (-30, 660), (670, -25), (320, 320))]
    n = len(cases)
    th = torch.linspace(-0.3, 0.3, n)
    A = torch.zeros((n, 2, 3))
    for k, (x, y, sc) in enumerate(cases):
        c, s_ = sc * float(torch.cos(th[k])), sc * float(torch.sin(th[k]))
        A[k] = torch.tensor([[c, -s_, 0.0], [s_, c, 0.0]])
        A[k, :, 2] = torch.tensor([x, y]) - A[k, :, :2] @ torch.tensor([95.5, 95.5])
    A = A.to(dev)
    levels = frac_window_levels(H, window)
    level, strip0s, r, off_y, x0f, _ = window_geometry_frac(A, out, (H, W), window, levels,
                                                            y_align=16)
    assert set(level.tolist()) == set(range(levels)) and float(r.max()) > 5.0
    assert (r == 1.0).any()
    strip0 = strip0s[level.long(), torch.arange(n, device=dev)]
    g = torch.Generator(device="cpu").manual_seed(5)
    frames = (torch.rand((n, H, W * C), generator=g) * 255).to(torch.bfloat16).to(dev)
    fn = wk.crop_frac if construction == "legacy" else wk.crop_frac_mxu
    acts = [torch.profiler.ProfilerActivity.CUDA]
    before = fn.launches
    with torch.profiler.profile(activities=acts) as prof:
        got = fn(frames, strip0, level, r, off_y, x0f, window, C)
        torch.cuda.synchronize()
    assert fn.launches == before + 1
    launched = [ev.key for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA for _ in range(ev.count)]
    assert len(launched) == 1 and "crop_frac_band_kernel" in launched[0], launched
    fidx = torch.arange(n, device=dev)
    assert torch.equal(got, _plain_crop(frames, strip0, level, r, off_y, x0f, window, fidx,
                                        construction))
    k = int(torch.nonzero(r == 1.0)[0, 0])  # r = 1: the window itself
    y0, x0 = int(strip0[k] + off_y[k]), int(x0f[k])
    src = frames[k].reshape(H, W, C)[y0:y0 + window, x0:x0 + window]
    assert torch.equal(got[k].reshape(window, window, C), src)


@pytest.mark.parametrize("pixels", ["integer", "general"])
def test_crop_pool_kernel_matches_plain(dev, pixels):
    """Integer-valued pixels: the f32 sums are exact in any order, so bit
    for bit. General bf16 pixels: the order of the 2ˡ-term sums may move a
    result by one bf16 step."""
    H, W, C, window, out, N, B = 640, 640, 3, 160, (224, 224), 96, 8
    A = _affines(N, H, W, out, dev, seed=2)
    levels = max_window_levels((H, W), window)
    level, y0s, x0s, _ = window_geometry(A, out, (H, W), window, levels, y_align=16)
    assert levels == 3 and set(level.tolist()) == {0, 1, 2}
    idx = torch.arange(N, device=dev)
    y0_l0 = y0s[level.long(), idx] << level
    x0 = x0s[level.long(), idx]
    if pixels == "integer":
        frames = torch.randint(0, 256, (B, H, W * C), device=dev).to(torch.bfloat16)
    else:
        frames = (torch.rand((B, H, W * C), device=dev) * 255).to(torch.bfloat16)
    fidx = idx % B
    before = wk.crop_pool.launches
    got = wk.crop_pool(frames, y0_l0, x0, level, window, C, frame_idx=fidx)
    torch.cuda.synchronize()
    assert wk.crop_pool.launches == before + 1
    want = wk.crop_pool_plain(frames, y0_l0.int(), x0.int(), level.int(), window, C, fidx.int())
    if pixels == "integer":
        assert torch.equal(got, want)
    else:
        assert (got.float() - want.float()).abs().max() <= 1.0  # one bf16 step below 256
    # Level 0 is a pure crop of the frame.
    k = int(torch.nonzero(level == 0)[0, 0])
    y, x = int(y0_l0[k]), int(x0[k])
    src = frames[int(fidx[k])].reshape(H, W, C)[y:y + window, x:x + window]
    assert torch.equal(got[k].reshape(window, window, C), src)


@pytest.mark.parametrize("M,K,N,scales,bias", [
    (128 * 576, 56, 336, 1, True),       # largest M of the tail, K not a multiple of 32 or 16
    (128 * 144, 160, 960, 128, True),    # K = 5 mma steps, per-image dynamic scales
    (128 * 36, 2688, 448, 128, True),    # largest K, per-image dynamic scales
    (1000, 960, 160, 1, False),          # ragged M tile, no bias
    (70, 112, 52, 70, True),             # ragged N tile, one scale per row
    (300, 4, 4, 300, False),             # K = 4 (4-byte copies), N = 4, per row, no bias
    (257, 36, 52, 1, True),              # K = 36: ragged K step of 4-byte copies
])
@pytest.mark.parametrize("layout", ["k_major", "row_major"])
def test_int8_gemm_kernel_matches_plain(dev, M, K, N, scales, bias, layout):
    """Bit for bit, on operands spanning [-128, 127] with rows and columns
    at the extremes; the K-major weights (the tail runner's) are read as
    they are, row-major ones copied first."""
    g = torch.Generator(device="cpu").manual_seed(M + K)
    xq = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
    wq = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8)
    xq[0], xq[-1], wq[:, 0], wq[:, -1] = -128, 127, -128, 127
    xq, wq = xq.to(dev), wq.to(dev)
    if layout == "k_major":
        wq = wq.t().contiguous().t()
    sx = (torch.rand(scales, generator=g) * 0.05 + 0.01).to(dev)
    sw = (torch.rand(N, generator=g) * 0.01 + 0.001).to(dev)
    b = torch.randn(N, generator=g).to(dev) if bias else None
    before = ik.int8_gemm.launches
    got = ik.int8_gemm(xq, wq, sx, sw, b)
    torch.cuda.synchronize()
    assert ik.int8_gemm.launches == before + 1
    assert torch.equal(got, ik.int8_gemm_plain(xq, wq, sx, sw, b))


@pytest.mark.parametrize("shape,cout,k,stride,scales", [
    ((32, 160, 160, 32), 32, 3, 2, 1),    # stem conv 2
    ((32, 40, 40, 64), 64, 3, 1, 32),     # FPN / tower, per-image scales
    ((32, 10, 10, 256), 256, 3, 1, 1),    # widest block
    ((32, 80, 80, 32), 64, 1, 2, 1),      # 1×1 stride-2 shortcut
    ((3, 21, 13, 32), 36, 3, 2, 3),       # odd sizes, ragged tiles
])
def test_int8_conv_kernel_matches_plain(dev, shape, cout, k, stride, scales):
    g = torch.Generator(device="cpu").manual_seed(shape[1] + cout)
    xq = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)
    kq = torch.randint(-127, 128, (k, k, shape[3], cout), generator=g, dtype=torch.int8).to(dev)
    sx = (torch.rand(scales, generator=g) * 0.05 + 0.01).to(dev)
    sw = (torch.rand(cout, generator=g) * 0.01 + 0.001).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    before = ik.int8_conv.launches
    got = ik.int8_conv(xq, kq, sx, sw, b, stride)
    torch.cuda.synchronize()
    assert ik.int8_conv.launches == before + 1
    assert torch.equal(got, ik.int8_conv_plain(xq, kq, sx, sw, b, stride))


def test_warp_kernel_matches_plain(dev):
    N, S, out = 64, 128, (192, 192)
    g = torch.Generator(device="cpu").manual_seed(1)
    crop = (torch.rand((N, S, S, 3), generator=g) * 255).to(dev)
    ang = torch.rand(N, generator=g) * 0.8 - 0.4
    sc = torch.rand(N, generator=g) * 0.6 + 0.4
    A = torch.stack([torch.stack([sc * ang.cos(), -sc * ang.sin(), torch.rand(N, generator=g) * 20 - 5], -1),
                     torch.stack([sc * ang.sin(), sc * ang.cos(), torch.rand(N, generator=g) * 20 - 5], -1)],
                    1).to(dev)
    before = wk.warp_affine_legacy.launches
    got = wk.warp_affine_legacy(crop, A, out, inverse=True)
    torch.cuda.synchronize()
    assert wk.warp_affine_legacy.launches == before + 1
    want = wk.warp_affine_legacy_plain(crop.to(torch.bfloat16), A.reshape(N, 6), out)
    assert torch.equal(got, want)
    assert (got == 0).any() and torch.isfinite(got).all()


@pytest.mark.parametrize("shared_frames", [False, True])
def test_crop_frac_mxu_kernel_matches_plain(dev, shared_frames):
    """The rank-1 ("mxu") taps of the fractional crop, at the int8-tap
    path's shapes; r = 1 faces copy their window exactly."""
    H, W, C, window, out, N = 640, 640, 3, 128, (192, 192), 96
    level, strip0s, r, off_y, x0f, _ = _faces(N, H, W, window, out, dev, seed=3)
    strip0 = strip0s[level.long(), torch.arange(N, device=dev)]
    B = 8 if shared_frames else N
    frames = torch.randint(0, 256, (B, H, W * C), device=dev).to(torch.bfloat16)
    fidx = torch.arange(N, device=dev) % B
    before = (wk.crop_frac_mxu.launches, wk.crop_frac.launches)
    got = wk.crop_frac_mxu(frames, strip0, level, r, off_y, x0f, window, C, frame_idx=fidx)
    torch.cuda.synchronize()
    assert (wk.crop_frac_mxu.launches, wk.crop_frac.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, _plain_crop(frames, strip0, level, r, off_y, x0f, window, fidx, "mxu"))
    exact = r == 1.0
    assert exact.any()
    legacy = wk.crop_frac(frames, strip0, level, r, off_y, x0f, window, C, frame_idx=fidx)
    assert torch.equal(got[exact], legacy[exact])


@pytest.mark.parametrize("mode", ["uw", "uw16", "int8"])
@pytest.mark.parametrize("pixels", ["integer", "bf16"])
def test_tap_mode_warp_kernels_match_plain(dev, mode, pixels):
    """The rank-1 ("uw"/"uw16") and int8 warp kernels at the paths' shapes
    (160² crops to 224², 128² crops to 192²): bit for bit, also on a
    non-integer bf16 crop (the int8 kernel quantizes it half to even)."""
    N, S, out = (96, 160, (224, 224)) if mode != "int8" else (64, 128, (192, 192))
    g = torch.Generator(device="cpu").manual_seed(4)
    crop = torch.rand((N, S, S, 3), generator=g) * 255
    crop = (crop.round() if pixels == "integer" else crop.to(torch.bfloat16).float()).to(dev)
    ang = torch.rand(N, generator=g) * 0.8 - 0.4
    sc = torch.rand(N, generator=g) * 0.6 + 0.4
    A = torch.stack([torch.stack([sc * ang.cos(), -sc * ang.sin(), torch.rand(N, generator=g) * 20 - 5], -1),
                     torch.stack([sc * ang.sin(), sc * ang.cos(), torch.rand(N, generator=g) * 20 - 5], -1)],
                    1).to(dev)
    kernel = wk.WARP_KERNELS[mode]
    others = [k for name, k in wk.WARP_KERNELS.items() if name != mode]
    before = kernel.launches, [k.launches for k in others]
    got = kernel(crop, A, out, inverse=True)
    torch.cuda.synchronize()
    assert (kernel.launches, [k.launches for k in others]) == (before[0] + 1, before[1])
    plain = wk.warp_affine_int8_plain if mode == "int8" else wk.warp_affine_uw_plain
    want = plain(crop.to(torch.bfloat16), A.reshape(N, 6), out)
    assert torch.equal(got, want)
    assert (got == 0).any() and torch.isfinite(got).all()
    if mode == "uw16":
        assert torch.equal(got, wk.warp_affine_uw(crop, A, out, inverse=True))


def test_int8_warp_kernel_border_is_exact_zero(dev):
    img = torch.full((1, 48, 48, 3), 200.0, device=dev)
    A_inv = torch.tensor([[[1.0, 0.0, 30.0], [0.0, 1.0, 0.0]]], device=dev)  # dst→src
    got = wk.warp_affine_int8(img, A_inv, (48, 48), inverse=True)
    assert got[0, :, -5:].max().item() == 0.0
    want = wk.warp_affine_int8_plain(img.to(torch.bfloat16), A_inv.reshape(1, 6), (48, 48))
    assert torch.equal(got, want)


def _randomize_bn(module, seed):
    """BatchNorm parameters and statistics away from the identity."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            n = m.weight.shape[0]
            with torch.no_grad():
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + (0.2 * torch.randn(n, generator=g)).abs())
    return module


def _assert_two_bf16_steps(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    excess = (got - want).abs() - 2.0 ** -7 * want.abs().clamp_min(1.0)
    assert excess.max() <= 0, (f"{int((excess > 0).sum())} of {want.numel()} beyond two bf16 "
                               f"steps, worst {float((got - want).abs().max())}")


B4 = block_args("b4")


@pytest.mark.parametrize("args,h,B", [
    (dict(kernel=3, stride=1, expand_ratio=6, in_filters=16, out_filters=16, se_ratio=0.25), 13, 3),
    (dict(kernel=3, stride=2, expand_ratio=6, in_filters=16, out_filters=24, se_ratio=0.25), 32, 3),
    (dict(kernel=5, stride=1, expand_ratio=6, in_filters=24, out_filters=24, se_ratio=0.25), 16, 3),
    (dict(kernel=5, stride=2, expand_ratio=6, in_filters=24, out_filters=40, se_ratio=0.25), 22, 3),
    (dict(kernel=3, stride=1, expand_ratio=1, in_filters=32, out_filters=16, se_ratio=0.25), 9, 3),
    (B4[1], 96, 8), (B4[2], 96, 8), (B4[3], 48, 8), (B4[6], 48, 8), (B4[7], 24, 8),
    (B4[10], 28, 4), (B4[16], 14, 4), (B4[17], 14, 4),
], ids=["k3s1-ragged", "k3s2", "k5s1", "k5s2-ragged", "no-expand-ragged", "b4-1@96", "b4-2@96",
        "b4-3@48", "b4-6@48", "b4-7@24", "b4-10@28", "b4-16@14", "b4-17@14"])
def test_fused_block_kernel_matches_plain(dev, args, h, B):
    blk = _randomize_bn(init_weights(MBConvBlock(**args), h), h + 1).to(dev).eval()
    bp = fs.block_plan_from_args(args)
    w = fs.fold_block_weights(blk, bp)
    g = torch.Generator(device="cpu").manual_seed(h)
    x = torch.randn((B, h, h, bp.cin), generator=g).to(dev).to(torch.bfloat16)
    before = fs.run_block.launches
    got = fs.run_block(bp, x, w)
    torch.cuda.synchronize()
    assert fs.run_block.launches == before + 1
    _assert_two_bf16_steps(got, fs.run_block_plain(bp, x, w))
    again = fs.run_block(bp, x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # fixed-order sums: the same bits every run
    # Against the unfused module (float32, BatchNorm not folded).
    with torch.no_grad():
        ref = blk(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got.float(), ref, atol=0.03, rtol=0.05)


@pytest.mark.parametrize("variant,shape", [("b0", (2, 20, 12, 3)), ("b4", (4, 192, 192, 3)),
                                           ("b4", (4, 224, 224, 3))])
def test_fused_stem_kernel_matches_plain(dev, variant, shape):
    bb = _randomize_bn(init_weights(EfficientNetBackbone(variant), 3), 4).to(dev).eval()
    w = fs.fold_stem_weights(bb)
    g = torch.Generator(device="cpu").manual_seed(shape[1])
    x = torch.randn(shape, generator=g).to(dev).to(torch.bfloat16)
    before = fs.run_stem.launches
    got = fs.run_stem(x, w)
    torch.cuda.synchronize()
    assert fs.run_stem.launches == before + 1
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, w[0].shape[0])
    _assert_two_bf16_steps(got, fs.run_stem_plain(x, w))


@pytest.mark.parametrize("idx,h,B", [(0, 11, 3), (3, 48, 8), (12, 14, 8)],
                         ids=["b4-0-no-expand-ragged", "b4-3@48", "b4-12@14"])
def test_fused_mbconv_kernel_matches_plain(dev, idx, h, B):
    args = B4[idx]
    blk = _randomize_bn(init_weights(MBConvBlock(**args), idx), idx + 1).to(dev).eval()
    folded = fm.fold_mbconv_params(blk, args["expand_ratio"])
    g = torch.Generator(device="cpu").manual_seed(idx)
    x = torch.randn((B, h, h, args["in_filters"]), generator=g).to(dev)
    before = fm.fused_mbconv.launches
    got = fm.fused_mbconv(x, folded, args["expand_ratio"])
    torch.cuda.synchronize()
    assert fm.fused_mbconv.launches == before + 1
    assert got.shape == (B, h, h, args["out_filters"]) and got.dtype == torch.bfloat16
    _assert_two_bf16_steps(got, fm.fused_mbconv_plain(x, folded, args["expand_ratio"]))


def test_kernels_reject_wrong_inputs(dev):
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        wk.crop_frac(torch.zeros((1, 128, 384), device=dev), z, z, torch.ones(1, device=dev),
                     z, z, 128, 3)
    with pytest.raises(ValueError):
        wk.crop_frac(torch.zeros((1, 128, 384), device=dev, dtype=torch.bfloat16), z, z,
                     torch.ones(1), z, z, 128, 3)  # r on the CPU
    with pytest.raises(TypeError):
        wk.crop_frac_mxu(torch.zeros((1, 128, 384), device=dev), z, z, torch.ones(1, device=dev),
                         z, z, 128, 3)
    with pytest.raises(TypeError):
        wk.crop_pool(torch.zeros((1, 128, 384), device=dev), z, z, z, 128, 3)
    with pytest.raises(ValueError):
        wk.warp_affine_int8(torch.zeros((2, 8, 8, 3), device=dev), torch.zeros((1, 2, 3), device=dev),
                            (4, 4))
    with pytest.raises(ValueError):
        wk.warp_affine_uw16(torch.zeros((1, 8, 8, 3), device=dev), torch.zeros((1, 2, 3)), (4, 4),
                            inverse=True)  # matrices on the CPU
    q = torch.zeros((8, 8), dtype=torch.int8, device=dev)
    one = torch.ones(1, device=dev)
    with pytest.raises(TypeError):
        ik.int8_gemm(q.float(), q, one, torch.ones(8, device=dev))
    with pytest.raises(ValueError):
        ik.int8_gemm(q, q, one, torch.ones(8))  # sw on the CPU
    with pytest.raises(ValueError):
        ik.int8_conv(q.reshape(1, 2, 4, 8), q.reshape(1, 1, 8, 8), torch.ones(3, device=dev),
                     torch.ones(8, device=dev))  # 3 scales for 1 image
    args = B4[3]
    bp = fs.block_plan_from_args(args)
    w = fs.fold_block_weights(init_weights(MBConvBlock(**args), 0).to(dev), bp)
    x = torch.zeros((1, 8, 8, bp.cin), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        fs.run_block(bp, x.float(), w)
    with pytest.raises(ValueError):
        fs.run_block(bp, x, [w[0].cpu()] + w[1:])  # w_exp on the CPU
    with pytest.raises(ValueError):
        fs.run_stem(torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16, device=dev),
                    [torch.zeros((48, 27), dtype=torch.bfloat16), torch.zeros(48, device=dev)])
