"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU: ``pytest -m gpu tests/test_torch_gpu_kernels.py``.
Without one every test skips. The warp and int8 kernels apply their plain
versions' rounding points and exact sums, so they must agree bit for bit.
The fused stem / MBConv kernels sum in another order than their plain
versions and take ``expf`` where those take ``torch.sigmoid``: they agree
within two bf16 steps of the value, ``|k − p| ≤ 2⁻⁷ · max(|p|, 1)``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone, MBConvBlock, block_args
from deepfake_vit_tpu_torch.models.layers import BatchNorm, init_weights
from deepfake_vit_tpu_torch.ops import bn_epilogue as be
from deepfake_vit_tpu_torch.ops import fused_mbconv as fm
from deepfake_vit_tpu_torch.ops import fused_stages as fs
from deepfake_vit_tpu_torch.ops import int8_kernel as ik
from deepfake_vit_tpu_torch.ops import layer_norm as ln
from deepfake_vit_tpu_torch.ops import self_attention as sa
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
    before, calls = fn.launches, []
    launched = _device_launches(
        lambda: calls.append(fn(frames, strip0, level, r, off_y, x0f, window, C)))
    assert fn.launches == before + len(calls)
    got = calls[-1]
    assert len(launched) == 1 and "crop_frac_band_kernel" in launched[0], launched
    fidx = torch.arange(n, device=dev)
    assert torch.equal(got, _plain_crop(frames, strip0, level, r, off_y, x0f, window, fidx,
                                        construction))
    k = int(torch.nonzero(r == 1.0)[0, 0])  # r = 1: the window itself
    y0, x0 = int(strip0[k] + off_y[k]), int(x0f[k])
    src = frames[k].reshape(H, W, C)[y0:y0 + window, x0:x0 + window]
    assert torch.equal(got[k].reshape(window, window, C), src)


@pytest.mark.parametrize("N,B", [(96, 8), (128, None), (96, 32)],
                         ids=["96-faces-on-8-frames", "path-B-128-faces", "path-F-96-on-32"])
@pytest.mark.parametrize("pixels", ["integer", "general"])
def test_crop_pool_kernel_matches_plain(dev, pixels, N, B):
    """Integer-valued pixels: the f32 sums are exact in any order, so bit
    for bit. General bf16 pixels: the order of the 2ˡ-term sums may move a
    result by one bf16 step. Faces sharing frames, and path B's served
    shape: one frame a face, frame_idx None."""
    H, W, C, window, out = 640, 640, 3, 160, (224, 224)
    A = _affines(N, H, W, out, dev, seed=2)
    levels = max_window_levels((H, W), window)
    level, y0s, x0s, _ = window_geometry(A, out, (H, W), window, levels, y_align=16)
    assert levels == 3 and set(level.tolist()) == {0, 1, 2}
    idx = torch.arange(N, device=dev)
    y0_l0 = y0s[level.long(), idx] << level
    x0 = x0s[level.long(), idx]
    n_frames = B or N
    if pixels == "integer":
        frames = torch.randint(0, 256, (n_frames, H, W * C), device=dev).to(torch.bfloat16)
    else:
        frames = (torch.rand((n_frames, H, W * C), device=dev) * 255).to(torch.bfloat16)
    fidx = idx % n_frames
    before = wk.crop_pool.launches
    got = wk.crop_pool(frames, y0_l0, x0, level, window, C, frame_idx=fidx if B else None)
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


def _device_launches(fn):
    """The names of the device kernels one call of fn() launches, one entry a
    launch, from the profiler. Now and then a profile comes back without any
    device record (chip_smoke.device_ms retakes those too); every call
    launches at least one kernel, so an empty profile is taken again."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        launched = [ev.key for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA for _ in range(ev.count)]
        if launched:
            break
    return launched


@pytest.mark.parametrize("W", [640, 644])
@pytest.mark.parametrize("pixels", ["integer", "general"])
def test_crop_pool_kernel_edges(dev, W, pixels):
    """Faces at every residue of x0·2ˡ·C·2 mod 16 at levels 0-2 (and 3, past
    the geometry's, whose output rows span two stages), windows partly and
    wholly outside the frame on every side, several faces a frame; W = 644
    takes the per-element path (rows differ in phase). Integer-valued
    pixels: bit for bit; general bf16 pixels: within one bf16 step. One
    device launch a call, with frame_idx None too."""
    H, C, window, B = 320, 3, 64, 6
    faces = []  # (level, level-0 row offset, selected-level column offset)
    for l in range(4):
        for k in range(8):  # x0 << l residues 0..7 (mod 8 elements: every 16-byte residue)
            faces.append((l, (k * 37) % (H - (window << min(l, 2))) - 8 * (k == 3), 8 * k + k))
        faces += [(l, -(window << l) // 2, -window // 2), (l, H - (window << l) // 3, 3),
                  (l, 5, (W >> l) - window // 3), (l, -(window << l) - 4, 0),
                  (l, 0, (W >> l) + 2)]
    level = torch.tensor([f[0] for f in faces], dtype=torch.int32, device=dev)
    y0_l0 = torch.tensor([f[1] for f in faces], dtype=torch.int32, device=dev)
    x0 = torch.tensor([f[2] for f in faces], dtype=torch.int32, device=dev)
    N = len(faces)
    g = torch.Generator(device="cpu").manual_seed(W)
    frames = torch.rand((B, H, W * C), generator=g) * 255
    frames = (frames.round() if pixels == "integer" else frames).to(torch.bfloat16).to(dev)
    fidx = torch.arange(N, device=dev).int() % B
    before = wk.crop_pool.launches
    got = wk.crop_pool(frames, y0_l0, x0, level, window, C, frame_idx=fidx)
    torch.cuda.synchronize()
    assert wk.crop_pool.launches == before + 1
    launched = _device_launches(
        lambda: wk.crop_pool(frames, y0_l0, x0, level, window, C, frame_idx=fidx))
    assert len(launched) == 1 and "crop_pool_band_kernel" in launched[0], launched
    want = wk.crop_pool_plain(frames, y0_l0, x0, level, window, C, fidx)
    if pixels == "integer":
        assert torch.equal(got, want)
    else:
        assert (got.float() - want.float()).abs().max() <= 1.0  # one bf16 step below 256
    assert not got[-1].float().any() and not got[-2].float().any()  # wholly outside
    # frame_idx None: one frame a face, still one launch.
    own = frames[fidx.long()]
    launched = _device_launches(lambda: wk.crop_pool(own, y0_l0, x0, level, window, C))
    assert len(launched) == 1 and "crop_pool_band_kernel" in launched[0], launched
    assert torch.equal(wk.crop_pool(own, y0_l0, x0, level, window, C), got)


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
    if layout == "k_major":  # read as they are: the kernel alone on the device
        launched = _device_launches(lambda: ik.int8_gemm(xq, wq, sx, sw, b))
        assert len(launched) == 1 and "int8_gemm_mma_kernel" in launched[0], launched


# (H, Cin, Cout, k, stride) of the int8 detector's 25 convolutions at the
# 320² canvas: 12 distinct shapes (tests/test_torch_conv_plan.py records them
# from the runner).
_DETECTOR_CONVS = ((160, 32, 32, 3, 2), (80, 32, 64, 3, 2), (80, 32, 64, 1, 2), (40, 64, 64, 3, 1),
                   (40, 64, 128, 3, 2), (40, 64, 128, 1, 2), (20, 64, 64, 3, 1),
                   (20, 128, 128, 3, 1), (20, 128, 256, 3, 2), (20, 128, 256, 1, 2),
                   (10, 64, 64, 3, 1), (10, 256, 256, 3, 1))


@pytest.mark.parametrize("shape,cout,k,stride,scales,bias,layout", [
    *(((b, h, h, cin), cout, k, s, 1, True, "k_major") for b in (32, 128)
      for h, cin, cout, k, s in _DETECTOR_CONVS),
    ((32, 40, 40, 64), 64, 3, 1, 32, True, "k_major"),   # per-image scales
    ((32, 10, 10, 256), 256, 3, 1, 1, False, "k_major"),  # no bias
    ((32, 80, 80, 32), 64, 1, 2, 1, True, "hwio"),       # a kernel that is not K-major: copied
    ((3, 21, 13, 32), 36, 3, 2, 3, True, "hwio"),        # odd sizes, ragged tiles
    ((2, 9, 11, 4), 8, 3, 1, 2, True, "k_major"),        # Cin 4: 4-byte copies, K = 36
    ((2, 12, 7, 12), 20, 3, 2, 1, False, "hwio"),        # Cin 12: 4-byte copies
    ((2, 10, 10, 24), 16, 1, 2, 2, True, "k_major"),     # Cin 24: 8-byte copies
])
def test_int8_conv_kernel_matches_plain(dev, shape, cout, k, stride, scales, bias, layout):
    """Bit for bit, on operands spanning [-128, 127] with images and output
    channels at the extremes, the detector's shapes at B = 32 and at the
    served 128; one launch a call, the kernel alone on the device where the
    kernels are K-major."""
    g = torch.Generator(device="cpu").manual_seed(shape[1] + cout)
    xq = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    kq = torch.randint(-128, 128, (k, k, shape[3], cout), generator=g, dtype=torch.int8)
    xq[0], xq[-1], kq[..., 0], kq[..., -1] = -128, 127, -128, 127
    xq, kq = xq.to(dev), kq.to(dev)
    if layout == "k_major":  # as ScrfdInt8Runner keeps its kernels
        kq = kq.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    sx = (torch.rand(scales, generator=g) * 0.05 + 0.01).to(dev)
    sw = (torch.rand(cout, generator=g) * 0.01 + 0.001).to(dev)
    b = torch.randn(cout, generator=g).to(dev) if bias else None
    before = ik.int8_conv.launches
    got = ik.int8_conv(xq, kq, sx, sw, b, stride)
    torch.cuda.synchronize()
    assert ik.int8_conv.launches == before + 1
    assert torch.equal(got, ik.int8_conv_plain(xq, kq, sx, sw, b, stride))
    if layout == "k_major":
        launched = _device_launches(lambda: ik.int8_conv(xq, kq, sx, sw, b, stride))
        assert len(launched) == 1 and "int8_conv_kernel" in launched[0], launched


def _similarities(spec, src, out, dev):
    """dst→src affines (N, 2, 3) from (roll in degrees, scale, mirrored,
    centre offset in source pixels) rows, centred on the (H, W) source."""
    A = np.zeros((len(spec), 2, 3))
    for k, (deg, scale, mirror, offset) in enumerate(spec):
        th = np.deg2rad(deg)
        R = scale * np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        if mirror:
            R[:, 0] *= -1.0
        A[k, :, :2] = R
        A[k, :, 2] = (np.asarray([src[1], src[0]]) - 1) / 2 + np.asarray(offset) - R @ np.asarray(
            [(out[1] - 1) / 2, (out[0] - 1) / 2])
    return torch.as_tensor(A, dtype=torch.float32, device=dev)


# Warp geometries: rolls of 0°, 30°, 90° and 180°, a mirror, a source wholly
# and one partly outside (128² crops to 192²; 160² to a ragged 37 × 53, which
# fills no tile evenly), a whole 640² frame at a down-scale of 3, whose tiles
# read their taps from device memory, and whole 1280×720 and 1920×1080 frames
# to 224² faces, as the predictor's aligner warps them. A source is a side
# or (H, W).
WARP_GEOMETRIES = {
    "rolls": (128, (192, 192), [(0, 0.62, False, (0, 0)), (30, 0.62, False, (0, 0)),
                                (90, 0.62, False, (3, -2)), (180, 0.62, False, (0, 0)),
                                (12, 0.62, True, (0, 0)), (20, 0.62, False, (400, -300)),
                                (45, 0.8, False, (70, 30))]),
    "ragged": (160, (37, 53), [(0, 2.5, False, (0, 0)), (-35, 1.3, True, (20, -50)),
                               (170, 0.9, False, (-60, 0))]),
    "down-scale": (640, (192, 192), [(10, 3.0, False, (0, 0)), (-60, 2.0, True, (100, 0))]),
    "720p frames": ((720, 1280), (224, 224), [(4, 0.9, False, (-300, 80)), (-8, 1.4, False, (250, -60))]),
    "1080p frames": ((1080, 1920), (224, 224), [(6, 2.2, False, (-500, 100)),
                                                (-3, 3.1, True, (400, -200))]),
}


def _check_warp_geometries(dev, mode):
    """One wrapper on every WARP_GEOMETRIES set: bit for bit against its
    plain version, zeros from a wholly-outside source, the kernel's branch
    per tile as warp_tile_box predicts it, and both branches taken."""
    g = torch.Generator(device="cpu").manual_seed(6)
    plain = {"legacy": wk.warp_affine_legacy_plain, "int8": wk.warp_affine_int8_plain}.get(
        mode, wk.warp_affine_uw_plain)
    taken = set()
    for name, (side, out, spec) in WARP_GEOMETRIES.items():
        src = (side, side) if isinstance(side, int) else side
        img = (torch.rand((len(spec), *src, 3), generator=g) * 255).to(torch.bfloat16)
        img, A = img.to(dev), _similarities(spec, src, out, dev)
        before = wk.WARP_KERNELS[mode].launches
        got, branch = wk.warp_tile_branches(mode, img, A, out, inverse=True)
        torch.cuda.synchronize()
        assert wk.WARP_KERNELS[mode].launches == before + 1
        assert torch.equal(got, plain(img, A.reshape(-1, 6), out)), name
        box = wk.warp_tile_box(A.reshape(-1, 6), out, src, 3)
        assert torch.equal(branch, torch.where(box.staged, 1, 2).to(torch.int32)), name
        assert torch.equal(got, wk.WARP_KERNELS[mode](img, A, out, inverse=True)), name
        if name == "rolls":
            assert not got[5].any()  # wholly outside: border 0
        taken |= set(branch.unique().tolist())
    assert taken == {1, 2}


def test_warp_kernel_matches_plain(dev):
    """The legacy warp at path A's shapes, then on the warp geometries."""
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
    crop16 = crop.to(torch.bfloat16)
    launched = _device_launches(lambda: wk.warp_affine_legacy(crop16, A, out, inverse=True))
    assert len(launched) == 1 and "warp_tile_kernel" in launched[0], launched
    _check_warp_geometries(dev, "legacy")


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
    non-integer bf16 crop (the int8 kernel quantizes it half to even); then
    on the warp geometries."""
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
    crop16 = crop.to(torch.bfloat16)
    launched = _device_launches(lambda: kernel(crop16, A, out, inverse=True))
    assert len(launched) == 1 and "warp_tile_kernel" in launched[0], launched
    if pixels == "bf16":
        _check_warp_geometries(dev, mode)


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
    (block_args("b6")[24], 14, 4), (block_args("b7")[29], 14, 4),
    (dict(kernel=3, stride=1, expand_ratio=6, in_filters=16, out_filters=264, se_ratio=0.25), 9, 2),
    (dict(kernel=3, stride=1, expand_ratio=6, in_filters=24, out_filters=24, se_ratio=0.25), 11, 3),
    (dict(kernel=5, stride=1, expand_ratio=6, in_filters=56, out_filters=56, se_ratio=0.25), 10, 3),
    (B4[1], 96, 128), (B4[2], 96, 128), (B4[3], 48, 128), (B4[6], 48, 128), (B4[7], 24, 128),
    (B4[17], 14, 32), (block_args("b6")[24], 14, 32), (block_args("b7")[29], 14, 32),
], ids=["k3s1-ragged", "k3s2", "k5s1", "k5s2-ragged", "no-expand-ragged", "b4-1@96", "b4-2@96",
        "b4-3@48", "b4-6@48", "b4-7@24", "b4-10@28", "b4-16@14", "b4-17@14", "b6-24@14-cout200",
        "b7-29@14-cout224", "cout264-two-sweeps", "cin24-k-padded-residual",
        "cin56-k-padded-residual", "b4-1@96-B128", "b4-2@96-B128", "b4-3@48-B128",
        "b4-6@48-B128", "b4-7@24-B128", "b4-17@14-B32", "b6-24@14-B32", "b7-29@14-B32"])
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
                                           ("b4", (4, 224, 224, 3)), ("b4", (3, 10, 212, 3)),
                                           ("b7", (2, 18, 300, 3)), ("b4", (32, 192, 192, 3)),
                                           ("b0", (2, 20, 16, 3)), ("b7", (2, 18, 304, 3)),
                                           ("b4", (128, 192, 192, 3)), ("b4", (32, 224, 224, 3))],
                         ids=["b0-W%8=4", "b4@192", "b4@224", "b4-3-bands-W%8=4",
                              "b7-5-bands-2-segments-W%8=4", "b4@192-B32-items-outnumber-blocks",
                              "b0-16-byte-copies", "b7-16-byte-copies-2-segments",
                              "b4@192-B128-path-C", "b4@224-B32-path-D"])
def test_fused_stem_kernel_matches_plain(dev, variant, shape):
    """Within two bf16 steps (the tensor cores' order of the 27-term sum),
    one device launch a call; odd band counts with a ragged last band, rows
    not a multiple of 16 bytes (4-byte copies), two column segments, more
    work items than resident blocks (each block walks several, staging the
    next while it computes one), and widths other than B4's 48 channels at
    16-byte copies (the general instantiation)."""
    bb = _randomize_bn(init_weights(EfficientNetBackbone(variant), 3), 4).to(dev).eval()
    w = fs.fold_stem_weights(bb)
    g = torch.Generator(device="cpu").manual_seed(shape[1])
    x = torch.randn(shape, generator=g).to(dev).to(torch.bfloat16)
    before = fs.run_stem.launches
    got = fs.run_stem(x, w)
    torch.cuda.synchronize()
    assert fs.run_stem.launches == before + 1
    launched = _device_launches(lambda: fs.run_stem(x, w))
    assert len(launched) == 1 and "fused_stem_kernel" in launched[0], launched
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, w[0].shape[0])
    _assert_two_bf16_steps(got, fs.run_stem_plain(x, w))


@pytest.mark.parametrize("args,h,B", [
    (B4[0], 11, 3), (B4[3], 48, 8), (B4[12], 14, 8),
    (dict(kernel=3, stride=1, expand_ratio=6, in_filters=24, out_filters=24, se_ratio=0.25), 11, 3),
    (dict(kernel=3, stride=1, expand_ratio=6, in_filters=56, out_filters=56, se_ratio=0.25), 9, 3),
    (B4[3], 48, 128), (B4[12], 14, 128),
], ids=["b4-0-no-expand-ragged", "b4-3@48", "b4-12@14", "cin24-k-padded", "cin56-k-padded",
        "b4-3@48-B128", "b4-12@14-B128"])
def test_fused_mbconv_kernel_matches_plain(dev, args, h, B):
    blk = _randomize_bn(init_weights(MBConvBlock(**args), h), h + 1).to(dev).eval()
    folded = fm.fold_mbconv_params(blk, args["expand_ratio"])
    g = torch.Generator(device="cpu").manual_seed(h)
    x = torch.randn((B, h, h, args["in_filters"]), generator=g).to(dev)
    before = fm.fused_mbconv.launches
    got = fm.fused_mbconv(x, folded, args["expand_ratio"])
    torch.cuda.synchronize()
    assert fm.fused_mbconv.launches == before + 1
    assert got.shape == (B, h, h, args["out_filters"]) and got.dtype == torch.bfloat16
    _assert_two_bf16_steps(got, fm.fused_mbconv_plain(x, folded, args["expand_ratio"]))
    # Against the unfused module (float32, BatchNorm not folded).
    with torch.no_grad():
        ref = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got.float(), ref, atol=0.03, rtol=0.05)


# The B4's epilogues at 224² faces, B = 128 (and ragged batches): kernel,
# C, side. bn_act: the stem, block 2's expand (the largest), a depthwise
# output, the widest expand, the head; bn_add with the residual at each
# stage's width, and without; the gate at each stage's expanded width.
EPILOGUE_CASES = [
    ("bn_act", 128, 48, 112), ("bn_act", 128, 144, 112), ("bn_act", 128, 192, 56),
    ("bn_act", 128, 672, 14), ("bn_act", 128, 2688, 7), ("bn_act", 128, 1792, 7),
    ("bn_act", 5, 144, 112), ("bn_act", 3, 8, 1),
    ("bn_residual", 128, 24, 112), ("bn_residual", 128, 32, 56), ("bn_residual", 128, 56, 28),
    ("bn_residual", 128, 112, 14), ("bn_residual", 128, 160, 14), ("bn_residual", 128, 272, 7),
    ("bn_residual", 128, 448, 7), ("bn_residual", 7, 56, 28),
    ("bn", 128, 32, 56), ("bn", 128, 272, 7), ("bn", 3, 160, 14),
    ("se_gate", 128, 144, 56), ("se_gate", 128, 336, 28), ("se_gate", 128, 960, 14),
    ("se_gate", 128, 2688, 7), ("se_gate", 5, 672, 14),
]


def _epilogue_inputs(kind, B, C, H, dev, seed):
    """bf16 channels-last x (wide enough that SiLU meets both tails),
    a BatchNorm away from the identity, a residual, a gate through the
    sigmoid."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (4.0 * torch.randn((B, H, H, C), generator=g)).to(dev, torch.bfloat16).permute(0, 3, 1, 2)
    bn = BatchNorm(C, 1e-3).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.exp(torch.randn(C, generator=g)))
        bn.bias.copy_(torch.randn(C, generator=g))
        bn.running_mean.copy_(torch.randn(C, generator=g))
        bn.running_var.copy_(torch.exp(torch.randn(C, generator=g)))
    other = None
    if kind == "bn_residual":
        other = (2.0 * torch.randn((B, H, H, C), generator=g)).to(dev, torch.bfloat16)
        other = other.permute(0, 3, 1, 2)
    elif kind == "se_gate":
        other = torch.sigmoid((3.0 * torch.randn((B, C), generator=g)).to(dev, torch.bfloat16))
    return x, be.bn_factors(bn.to(dev)), other


@pytest.mark.parametrize("kind,B,C,H", EPILOGUE_CASES,
                         ids=[f"{k}-B{b}-C{c}-{h}" for k, b, c, h in EPILOGUE_CASES])
def test_epilogue_kernels_match_plain(dev, kind, B, C, H):
    """Bit for bit against the plain versions (PyTorch's own kernels on the
    card), one device launch a call, the output channels-last."""
    x, factors, other = _epilogue_inputs(kind, B, C, H, dev, B * C + H)
    if kind == "bn_act":
        fn, call, plain = be.bn_act, lambda: be.bn_act(x, factors), be.bn_act_plain(x, factors)
    elif kind == "se_gate":
        fn, call, plain = be.se_gate, lambda: be.se_gate(x, other), be.se_gate_plain(x, other)
    else:
        fn, call = be.bn_add, lambda: be.bn_add(x, factors, other)
        plain = be.bn_add_plain(x, factors, other)
    before = fn.launches
    got = call()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    diff = (got.float() - plain.float()).abs()
    assert torch.equal(got, plain), (f"{int((diff > 0).sum())} of {got.numel()} differ, worst "
                                     f"{float(diff.max())}")
    launched = _device_launches(call)
    assert len(launched) == 1 and ("bn_" in launched[0] or "se_gate" in launched[0]), launched


def _b4_with_bns(B4_seed=3):
    return _randomize_bn(init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), B4_seed),
                         B4_seed + 1)


def test_b4_backbone_with_the_epilogue_kernels_equals_the_eager_path(dev, monkeypatch):
    """The whole B4 at B = 8 in inference: 64 + 32 + 32 launches, the
    features equal the eager path's (the kernels switched off) bit for bit."""
    bb = _b4_with_bns().to(dev).eval()
    images = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(5)).to(dev)
    counts = (be.bn_act.launches, be.bn_add.launches, be.se_gate.launches)
    with torch.inference_mode():
        got = bb(images)
    torch.cuda.synchronize()
    assert tuple(n - c for n, c in zip((be.bn_act.launches, be.bn_add.launches,
                                         be.se_gate.launches), counts)) == (64, 32, 32)
    monkeypatch.setattr(be, "engages", lambda *a, **k: False)
    with torch.inference_mode():
        want = bb(images)
    assert torch.equal(got, want)


def test_train_step_takes_no_epilogue_kernel(dev, monkeypatch):
    """A bf16 channels-last train step of a B4 (train mode, autograd):
    no launch, and the loss and every gradient equal those of the eager path
    (deterministic cuDNN, so that two runs sum in one order)."""
    bb = _b4_with_bns().to(dev).train()
    bb.drop_connect_rate = 0.0
    images = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(6)).to(dev)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def step():
        bb.zero_grad(set_to_none=True)
        loss = bb(images, return_maps=False, generator=torch.Generator(device=dev).manual_seed(0))
        loss = loss.float().square().mean()
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in bb.parameters() if p.grad is not None]

    try:
        counts = (be.bn_act.launches, be.bn_add.launches, be.se_gate.launches)
        loss, grads = step()
        assert (be.bn_act.launches, be.bn_add.launches, be.se_gate.launches) == counts
        monkeypatch.setattr(be, "engages", lambda *a, **k: False)
        want_loss, want_grads = step()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert torch.equal(loss, want_loss) and len(grads) == len(want_grads) > 0
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_epilogue_kernels_replay_in_a_captured_graph(dev):
    """The B4 backbone captured in a CUDA graph at B = 4: a replay on new
    images equals the eager call with the kernels."""
    bb = _b4_with_bns().to(dev).eval()
    g = torch.Generator().manual_seed(7)
    static = torch.randn((4, 224, 224, 3), generator=g).to(dev)
    fresh = torch.randn((4, 224, 224, 3), generator=g).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.inference_mode():
        for _ in range(2):
            bb(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = be.bn_act.launches
    with torch.inference_mode():
        with torch.cuda.graph(graph):
            out = bb(static)
        assert be.bn_act.launches == before + 64
        static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        want = bb(fresh)
    assert torch.equal(out, want)


# The transformers' LayerNorms a served batch: the shape drawn, eps, the view
# whose rows are normalized. The ViT's 128 × 197 tokens; the TimeSformer's
# ln_t (16 clips × 196 patches × 8 frames, copied to patch-major rows), ln1
# (128 frames × 197), ln2 (16 × 1,569), its CLS rows (1,569 · 768 apart in
# the tokens) and a single clip's ln_t rows (196 patches × 8 frames, a view
# of the tokens in two strides); Swin-B's served rows (stage 1's 128 × 3,136
# tokens of 128 and the embedding's, stage 2's 128 × 784 of 256, the first
# merge's 784 of 512, stage 3's 128 × 196 of 512); other widths (ViT-S/16,
# ViT-Ti/16, tiny8) and a row that leaves lanes idle (W = 200).
LAYER_NORM_VIEWS = {
    "": lambda x: x,
    "cls": lambda x: x[:, 0],
    "one_clip_temporal": lambda x: (x[:, 1:].reshape(1, 8, 196, 768).transpose(1, 2)
                                    .reshape(196, 8, 768)),
}
LAYER_NORM_CASES = [
    ((128, 197, 768), 1e-12, ""), ((25088, 768), 1e-6, ""), ((25216, 768), 1e-6, ""),
    ((25104, 768), 1e-6, ""), ((16, 1569, 768), 1e-6, "cls"),
    ((1, 1569, 768), 1e-6, "one_clip_temporal"), ((7, 197, 384), 1e-12, ""),
    ((5, 197, 192), 1e-12, ""), ((3, 17, 64), 1e-6, ""), ((9, 200), 1e-6, ""),
    ((401408, 128), 1e-5, ""), ((100352, 256), 1e-5, ""), ((100352, 512), 1e-5, ""),
    ((25088, 512), 1e-5, ""),
]


def _layer_norm_inputs(shape, view, dev, seed):
    """bf16 rows with a mean away from 0 (a residual stream's), scale and
    bias away from the identity; the rows ``LAYER_NORM_VIEWS[view]``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    W = shape[-1]
    x = (1.5 + 4.0 * torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
    weight = (1.0 + 0.3 * torch.randn(W, generator=g)).to(dev)
    bias = (0.5 * torch.randn(W, generator=g)).to(dev)
    return LAYER_NORM_VIEWS[view](x), weight, bias


def _assert_one_bf16_step(got, want):
    """|k − p| at most one bf16 step of the larger of the two, plus 2⁻¹⁶ of
    the largest output: the kernel's float32 row sums run in another order
    than PyTorch's reduction, so a mean or variance may differ in its last
    bit and move an output across one rounding boundary; near 0 an output
    is the difference of terms as large as the largest, whose float32
    rounding outweighs a tiny value's bf16 step. Returns the largest
    difference and the shares of elements that differ and that differ by
    more than one bf16 step."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    diff = (got - want).abs()
    step = torch.ldexp(torch.ones_like(diff), e - 8)
    beyond = diff > step + 2.0 ** -16 * want.abs().max()
    assert not beyond.any(), (f"{int(beyond.sum())} of {want.numel()} beyond one bf16 step, "
                              f"worst {float(diff.max())}: kernel, plain "
                              f"{list(zip(got[beyond][:8].tolist(), want[beyond][:8].tolist()))}")
    share = float((diff > 0).float().mean())
    assert share <= 1e-2, f"{share:.2e} of the elements differ"
    return float(diff.max()), share, float((diff > step).float().mean())


@pytest.mark.parametrize("shape,eps,view", LAYER_NORM_CASES,
                         ids=[f"{'x'.join(map(str, s))}{'-' + v if v else ''}-eps{e:g}"
                              for s, e, v in LAYER_NORM_CASES])
def test_layer_norm_kernel_matches_plain(dev, shape, eps, view):
    """Within one bf16 step of the plain version (PyTorch's own kernels on
    the card), one launch a call, the output contiguous; strided rows
    without a copy. (The kernel table, ``chip_smoke.py``, reports the device
    launches a call: late in a process the profiler here loses the kernel's
    records.)"""
    x, weight, bias = _layer_norm_inputs(shape, view, dev, sum(shape))
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, weight, bias, eps)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == before + 1
    assert got.is_contiguous() and got.shape == x.shape and got.dtype == torch.bfloat16
    worst, share, near_zero = _assert_one_bf16_step(got, ln.layer_norm_plain(x, weight, bias,
                                                                            eps))
    print(f"layer_norm {tuple(x.shape)} eps {eps:g}: worst {worst:g}, {share:.2e} differ, "
          f"{near_zero:.2e} by more than one bf16 step")


def _count_layer_norms(model, images, grad=torch.inference_mode):
    before = ln.layer_norm.launches
    with grad():
        out = model(images)
    torch.cuda.synchronize()
    return ln.layer_norm.launches - before, out


def test_classifiers_hand_every_layer_norm_to_the_kernel(dev, monkeypatch):
    """In inference the ViT-B/16 launches 25 LayerNorm kernels a forward and
    the TimeSformer-Base 37 on one clip (the temporal ones on the rows of
    the tokens' transposed view, the final one on the CLS rows, both where
    they lie); the B4 launches none. Against the same model in float32
    the bf16 features with the kernels lie no farther than twice as far as
    the eager path's (the kernel switched off): the kernel's rare one-step
    differences grow through the blocks to bf16's own noise, no further."""
    from deepfake_vit_tpu_torch.models.timesformer import TimeSformerClassifier
    from deepfake_vit_tpu_torch.models.vit import ViTClassifier

    g = torch.Generator().manual_seed(8)
    cases = [(ViTClassifier("base16", dtype=torch.bfloat16), 25, 4),
             (TimeSformerClassifier("base16", dtype=torch.bfloat16), 37, 8)]
    for model, want, n in cases:
        model = init_weights(model, 9).to(dev).eval()
        images = torch.randn((n, 224, 224, 3), generator=g).to(dev)
        launches, (_, feats) = _count_layer_norms(model, images)
        assert launches == want, (type(model).__name__, launches)
        with monkeypatch.context() as mp:
            mp.setattr(ln, "engages", lambda *a: False)
            eager, (_, eager_feats) = _count_layer_norms(model, images)
            model.dtype = torch.float32
            _, (_, f32) = _count_layer_norms(model, images)
        assert eager == 0
        scale = f32.abs().max()
        rel = [float((f - f32).abs().max() / scale) for f in (feats, eager_feats)]
        apart = float((feats - eager_feats).abs().max() / scale)
        print(f"{type(model).__name__}: features {rel[0]:.2e} (kernel) and {rel[1]:.2e} (eager) "
              f"of their largest from float32's, {apart:.2e} apart")
        assert rel[0] <= 2 * rel[1]
        del model
    launches, _ = _count_layer_norms(_b4_with_bns().to(dev).eval(),
                                     torch.randn((2, 224, 224, 3), generator=g).to(dev))
    assert launches == 0


def test_vit_train_step_takes_no_layer_norm_kernel(dev):
    """A bf16 ViT forward recording autograd (the train step) and a float32
    one in inference launch no LayerNorm kernel."""
    from deepfake_vit_tpu_torch.models.vit import ViTClassifier

    images = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(10)).to(dev)
    for dtype, grad in ((torch.bfloat16, torch.enable_grad), (torch.float32, torch.inference_mode)):
        model = init_weights(ViTClassifier("tiny16", image_size=32, dtype=dtype), 0).to(dev)
        launches, _ = _count_layer_norms(model.train(grad is torch.enable_grad), images, grad)
        assert launches == 0


def test_layer_norm_rejects_wrong_inputs(dev):
    x, weight, bias = _layer_norm_inputs((4, 64), "", dev, 0)
    with pytest.raises(ValueError):
        ln.layer_norm(x, weight.cpu(), bias, 1e-6)  # weight on the CPU
    with pytest.raises(ValueError):
        ln.layer_norm(torch.zeros(4 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(4, 64),
                      weight, bias, 1e-6)  # 2-byte aligned
    with pytest.raises(TypeError):
        ln.layer_norm(x.float(), weight, bias, 1e-6)


# The attention core's calls a served batch: (B, L, heads). The ViT's and
# the TimeSformer's spatial attention (128 frames × 197 tokens, the long
# plan) and the TimeSformer's temporal attention (16 clips × 196 patches, 8
# frames each, the short plan, two sequences a tile); ragged lengths of both
# plans, 13 sequences of 5 heads (65 pairs: the short plan's last tile holds
# one), every long-plan instantiation and the longest sequence.
SELF_ATTENTION_CASES = [(128, 197, 12), (3136, 8, 12),
                        *((13, L, 5) for L in (1, 7, 9, 16, 17, 63, 65, 200, 256))]


def _qkv(B, L, heads, dev, seed):
    """A bf16 QKV product: q and k N(0, 1.5²), so that the scores spread as
    a trained network's do (σ ≈ 2.25), v N(0.5, 1)."""
    g = torch.Generator().manual_seed(seed)
    W = heads * sa.HEAD_DIM
    qk = 1.5 * torch.randn((B, L, 2 * W), generator=g)
    v = 0.5 + torch.randn((B, L, W), generator=g)
    return torch.cat([qk, v], -1).to(dev, torch.bfloat16)


def _attention_errors(qkv, heads, got, monkeypatch):
    """|kernel − float32| and |plain − float32| against float32 attention
    (no TF32) on the same bf16 inputs, and the bound of one bf16 step of the
    output plus 2⁻⁸ of the largest |v|: the weights' bf16 rounding (2⁻⁹ of
    each) moves an output by at most 2⁻⁹ · max |v − o|, which near o = 0 is
    more than the output's own step."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ref = sa.self_attention_plain(qkv.float(), heads)
    plain = sa.self_attention_plain(qkv, heads).float()
    got = got.float()
    _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
    vmax = qkv[..., 2 * heads * sa.HEAD_DIM:].float().abs().max()
    limit = torch.ldexp(torch.ones_like(ref), e - 8) + 2.0 ** -8 * vmax
    return (got - ref).abs(), (plain - ref).abs(), limit


@pytest.mark.parametrize("B,L,heads", SELF_ATTENTION_CASES,
                         ids=[f"{B}x{L}x{h}" for B, L, h in SELF_ATTENTION_CASES])
def test_self_attention_kernel_matches_float32(dev, monkeypatch, B, L, heads):
    """Against float32 attention on the same bf16 inputs the kernel lies at
    least as close as the eager bf16 path (``self_attention_plain``: its
    scores and weights rounded to bf16) in the mean and the largest
    difference, every output within one bf16 step (see
    ``_attention_errors``); one launch a call, the output contiguous."""
    qkv = _qkv(B, L, heads, dev, B * 1000 + L)
    before = sa.self_attention.launches
    got = sa.self_attention(qkv, heads)
    torch.cuda.synchronize()
    assert sa.self_attention.launches == before + 1
    assert got.shape == (B, L, heads * sa.HEAD_DIM) and got.is_contiguous()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    err, plain_err, limit = _attention_errors(qkv, heads, got, monkeypatch)
    print(f"self_attention {(B, L, heads)}: kernel max {float(err.max()):.3g} mean "
          f"{float(err.mean()):.3g}; eager bf16 max {float(plain_err.max()):.3g} mean "
          f"{float(plain_err.mean()):.3g}")
    beyond = err > limit
    assert not beyond.any(), f"{int(beyond.sum())} outputs beyond one bf16 step of float32's"
    assert float(err.mean()) <= float(plain_err.mean())
    assert float(err.max()) <= float(plain_err.max())


# The child of test_self_attention_is_one_device_launch: the device kernels
# one warmed call launches, from the profiler, as one JSON line.
ONE_LAUNCH_CHILD = """
import json, sys
import torch
from deepfake_vit_tpu_torch.ops import self_attention as sa

B, L, heads = map(int, sys.argv[1:])
qkv = torch.randn((B, L, 3 * heads * sa.HEAD_DIM), device="cuda").to(torch.bfloat16)
sa.self_attention(qkv, heads)
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    sa.self_attention(qkv, heads)
    torch.cuda.synchronize()
print(json.dumps([ev.key for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA for _ in range(ev.count)]))
"""


@pytest.mark.parametrize("B,L,heads", SELF_ATTENTION_CASES[:2],
                         ids=[f"{B}x{L}x{h}" for B, L, h in SELF_ATTENTION_CASES[:2]])
def test_self_attention_is_one_device_launch(dev, B, L, heads):
    """At the served shapes one call is one device launch of the kernel: no
    copy, no scalar tensor, no sync. Profiled in a process of its own: late
    in a process the profiler loses the kernel's records."""
    proc = subprocess.run([sys.executable, "-c", ONE_LAUNCH_CHILD, str(B), str(L), str(heads)],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    launched = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(launched) == 1 and "attention_kernel" in launched[0], launched


def test_self_attention_reads_strided_views_in_place(dev):
    """Rows in two strides, a multiple of 8 apart, are read where they lie:
    ``x[:, 1]`` of a (B, 2, L, 3W) tensor and a slice of wider rows give the
    contiguous copy's output bit for bit; rows whose stride is no multiple
    of 8, a last dim that is not contiguous, another head width, more than
    ``MAX_SEQ`` tokens, float32 or a 2-byte offset are refused."""
    B, L, heads = 6, 197, 3
    W3 = 3 * heads * sa.HEAD_DIM
    for L_case in (L, 8):
        big = _qkv(B * 2, L_case, heads, dev, 11).view(B, 2, L_case, W3)
        want = sa.self_attention(big[:, 1].contiguous(), heads)
        assert torch.equal(sa.self_attention(big[:, 1], heads), want)
        wide = torch.zeros((B, L_case, W3 + 8), dtype=torch.bfloat16, device=dev)
        wide[..., :W3] = big[:, 1]
        assert torch.equal(sa.self_attention(wide[..., :W3], heads), want)
    qkv = _qkv(2, 9, heads, dev, 12)
    with pytest.raises(ValueError):
        sa.self_attention(torch.zeros((2, 9, W3 + 4), dtype=torch.bfloat16,
                                      device=dev)[..., :W3], heads)  # rows 4 values apart
    with pytest.raises(ValueError):
        sa.self_attention(qkv.transpose(1, 2).contiguous().transpose(1, 2), heads)
    with pytest.raises(ValueError):
        sa.self_attention(qkv, 2 * heads)  # hd = 32
    with pytest.raises(ValueError):
        sa.self_attention(_qkv(1, sa.MAX_SEQ + 1, heads, dev, 13), heads)
    with pytest.raises(TypeError):
        sa.self_attention(qkv.float(), heads)
    with pytest.raises(ValueError):
        sa.self_attention(torch.zeros(2 * 9 * W3 + 1, dtype=torch.bfloat16,
                                      device=dev)[1:].view(2, 9, W3), heads)


def _count_attention(model, images, grad=torch.inference_mode):
    before = sa.self_attention.launches
    with grad():
        out = model(images)
    torch.cuda.synchronize()
    return sa.self_attention.launches - before, out


def test_classifiers_hand_every_attention_core_to_the_kernel(dev, monkeypatch):
    """In inference the ViT-B/16 launches 12 attention kernels a forward and
    the TimeSformer-Base 24 on one clip (12 spatial over 197 tokens, 12
    temporal over 8 frames); the B4 launches none. Against the same model in
    float32 the bf16 features with the kernel lie no farther than twice as
    far as the eager path's (the kernel switched off): a call of the kernel
    lies nearer float32 than the eager core (see
    ``test_self_attention_kernel_matches_float32``), but through 12 blocks
    the largest feature error is set by the roundings both paths share
    (GEMMs, GELU, residual adds), as in the LayerNorm's whole-model test."""
    from deepfake_vit_tpu_torch.models.timesformer import TimeSformerClassifier
    from deepfake_vit_tpu_torch.models.vit import ViTClassifier

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(18)
    cases = [(ViTClassifier("base16", dtype=torch.bfloat16), 12, 4),
             (TimeSformerClassifier("base16", dtype=torch.bfloat16), 24, 8)]
    for model, want, n in cases:
        model = init_weights(model, 19).to(dev).eval()
        images = torch.randn((n, 224, 224, 3), generator=g).to(dev)
        launches, (_, feats) = _count_attention(model, images)
        assert launches == want, (type(model).__name__, launches)
        with monkeypatch.context() as mp:
            mp.setattr(sa, "engages", lambda *a: False)
            eager, (_, eager_feats) = _count_attention(model, images)
            model.dtype = torch.float32
            _, (_, f32) = _count_attention(model, images)
        assert eager == 0
        scale = f32.abs().max()
        rel = [float((f - f32).abs().max() / scale) for f in (feats, eager_feats)]
        print(f"{type(model).__name__}: features {rel[0]:.2e} (kernel) and {rel[1]:.2e} (eager) "
              f"of their largest from float32's")
        assert rel[0] <= 2 * rel[1]
        del model
    launches, _ = _count_attention(_b4_with_bns().to(dev).eval(),
                                   torch.randn((2, 224, 224, 3), generator=g).to(dev))
    assert launches == 0


def test_vit_train_step_takes_no_attention_kernel(dev):
    """A bf16 ViT forward recording autograd (the train step), one in train
    mode with dropout and a float32 one in inference launch no attention
    kernel."""
    from deepfake_vit_tpu_torch.models.vit import ViTClassifier

    images = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(20)).to(dev)
    for dtype, grad, dropout in ((torch.bfloat16, torch.enable_grad, 0.0),
                                 (torch.bfloat16, torch.no_grad, 0.1),
                                 (torch.float32, torch.inference_mode, 0.0)):
        model = ViTClassifier("tiny16", image_size=32, dropout=dropout, dtype=dtype)
        model = init_weights(model, 0).to(dev).train(grad is not torch.inference_mode)
        launches, _ = _count_attention(model, images, grad)
        assert launches == 0


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
    xe, fe, _ = _epilogue_inputs("bn_act", 2, 16, 4, dev, 0)
    with pytest.raises(ValueError):
        be.bn_act(xe, fe.cpu())  # factors on the CPU
    with pytest.raises(ValueError):
        be.bn_act(torch.zeros(2 * 16 * 16 + 1, dtype=torch.bfloat16, device=dev)[1:].view(
            2, 4, 4, 16).permute(0, 3, 1, 2), fe)  # 2-byte aligned
    with pytest.raises(ValueError):
        fs.run_stem(torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16, device=dev),
                    [torch.zeros((48, 27), dtype=torch.bfloat16), torch.zeros(48, device=dev)])


def test_warp_at_the_training_shape_matches_plain(dev):
    """The train step's rotation: 32 ImageNet-normalized 224² faces
    (negative values included) rotated by up to 5° about their centers,
    one launch, bit for bit against the plain version."""
    from deepfake_vit_tpu_torch.ops.augment import draw_rotation, rotate, rotation_matrices
    from deepfake_vit_tpu_torch.ops.umeyama import invert_affine

    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn((32, 224, 224, 3), generator=g, device=dev) * 1.2
    theta = draw_rotation(32, 5.0, g, dev)
    lms = torch.rand((32, 5, 2), generator=g, device=dev) * 223
    wk.warp_affine_legacy.launches = 0
    out, _ = rotate(images, lms, theta)
    assert wk.warp_affine_legacy.launches == 1
    coeffs = invert_affine(rotation_matrices(theta, (224, 224))).reshape(32, 6).contiguous()
    want = wk.warp_affine_legacy_plain(images.to(torch.bfloat16), coeffs, (224, 224))
    assert (want < 0).any()
    assert torch.equal(out, want)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One AdamW step of a b0 at 64², float32 without TF32, dropout and
    drop-connect off, augmentation off: loss and grad_norm within 1e-4
    relative, the running statistics within 1e-4, and each parameter's
    update within 1e-2 lr of the CPU's on the elements whose CPU gradient
    is at least 1e-3 of the largest (Adam's first step moves every element
    by about lr, so a sign error moves it 2 lr away; below that floor
    float noise decides the sign)."""
    from deepfake_vit_tpu_torch.models.bridge import export_flax_variables
    from deepfake_vit_tpu_torch.models.feature_extractor import DeepfakeDetectionModel
    from deepfake_vit_tpu_torch.training import TrainState, create_optimizer, make_criterion
    from deepfake_vit_tpu_torch.training import make_train_step

    lr = 1e-4
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(0, 1, (4, 64, 64, 3)).astype(np.float32),
             "label": np.array([0, 1, 1, 0], np.int32),
             "landmarks": rng.uniform(8, 56, (4, 5, 2)).astype(np.float32)}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for where in ("cpu", "cuda"):
            model = init_weights(DeepfakeDetectionModel(
                variant="b0", classifier_hidden_dims=(16,), dropout_rate=0.0,
                feature_dropout_rate=0.0), 0).to(where)
            model.feature_extractor.backbone.drop_connect_rate = 0.0
            p0 = [p.detach().double().cpu() for p in model.parameters()]
            opt = create_optimizer(model.parameters(), {"type": "AdamW", "lr": lr}, 1.0)
            step = make_train_step(model, make_criterion({"type": "CombinedLoss"}), opt)
            m = {k: float(v) for k, v in step(TrainState(), batch, 0).items()}
            grads = torch.cat([p.grad.double().cpu().flatten() for p in model.parameters()])
            update = torch.cat([(p.detach().double().cpu() - q).flatten()
                                for p, q in zip(model.parameters(), p0)])
            runs[where] = m, export_flax_variables(model), grads, update
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (mc, vc, gc, uc), (mg, vg, _, ug) = runs["cpu"], runs["cuda"]
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k]), k
    big = gc.abs() >= 1e-3 * gc.abs().max()
    assert (ug - uc)[big].abs().max().item() <= 1e-2 * lr

    def flat(t, out, p=""):
        for k, v in t.items():
            flat(v, out, f"{p}/{k}") if isinstance(v, dict) else out.__setitem__(f"{p}/{k}", v)
        return out

    stats_c, stats_g = flat(vc["batch_stats"], {}), flat(vg["batch_stats"], {})
    assert max(np.abs(stats_g[k] - stats_c[k]).max() for k in stats_c) <= 1e-4


def test_optimizer_on_the_card_matches_the_cpu(dev):
    """The train CLI's AdamW with global-norm clipping, three steps on
    seeded leaves and gradients (the first unclipped, then clipped), card
    against CPU: parameters within 1e-3 lr. lr 1e-2 and weight decay 0.1,
    so the decay (lr · wd · p) is well above float32's resolution of p; a
    control, the card without weight decay, must lie beyond the limit (up
    to 1.7 lr)."""
    from deepfake_vit_tpu_torch.training import create_optimizer
    from deepfake_vit_tpu_torch.training.optim import clip_and_step

    lr, shapes = 1e-2, [(48, 3, 3, 3), (1792,), (1792, 448), (2, 32)]
    rng = np.random.default_rng(3)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1e-3 * (k + 1), s).astype(np.float32) for s in shapes]
             for k in range(3)]
    out = []
    for where, wd in (("cpu", 0.1), ("cuda", 0.1), ("cuda", 0.0)):
        ps = [torch.nn.Parameter(torch.tensor(p, device=where)) for p in p0]
        opt = create_optimizer(ps, {"type": "AdamW", "lr": lr, "weight_decay": wd}, 1.0)
        for g in grads:
            for p, x in zip(ps, g):
                p.grad = torch.tensor(x, device=where)
            clip_and_step(opt, ps)
        out.append([p.detach().double().cpu().numpy() for p in ps])
    gap, control = (max(np.abs(a - b).max() for a, b in zip(out[0], card)) / lr
                    for card in out[1:])
    print(f"optimizer card vs CPU: {gap:.3g} lr; control without weight decay {control:.3g} lr")
    assert gap <= 1e-3 < control
