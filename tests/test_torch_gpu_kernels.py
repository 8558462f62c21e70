"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA GPU: ``pytest -m gpu tests/test_torch_gpu_kernels.py``.
Without one every test skips. Kernel and plain version apply the same
rounding points, so they must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from deepfake_vit_tpu_torch.ops import warp_kernel as wk
from deepfake_vit_tpu_torch.ops.warp import frac_window_levels, window_geometry_frac

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    wk.build_library()
    return torch.device("cuda")


def _faces(n, H, W, window, out, dev, seed=0):
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(np.log(0.3), np.log(3.6), n))
    s[: n // 4] = 0.4
    th = rng.uniform(-0.35, 0.35, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    center = rng.uniform(-40, max(H, W) + 40, (n, 2))
    t = center - np.einsum("nij,j->ni", R, np.asarray([(out[1] - 1) / 2, (out[0] - 1) / 2]))
    A = torch.as_tensor(np.concatenate([R, t[..., None]], -1), dtype=torch.float32, device=dev)
    return window_geometry_frac(A, out, (H, W), window, frac_window_levels(H, window), y_align=16)


@pytest.mark.parametrize("shared_frames", [False, True])
def test_crop_frac_kernel_matches_plain(dev, shared_frames):
    H, W, C, window, out, N = 640, 640, 3, 128, (192, 192), 96
    level, strip0s, r, off_y, x0f, _ = _faces(N, H, W, window, out, dev)
    strip0 = strip0s[level.long(), torch.arange(N, device=dev)]
    B = 8 if shared_frames else N
    frames = torch.randint(0, 256, (B, H, W * C), device=dev).to(torch.bfloat16)
    fidx = torch.arange(N, device=dev) % B
    before = wk.crop_frac.launches
    got = wk.crop_frac(frames, strip0, level, r, off_y, x0f, window, C, frame_idx=fidx)
    torch.cuda.synchronize()
    assert wk.crop_frac.launches == before + 1
    want = wk.crop_frac_plain(frames, strip0.int(), level.int(), torch.round(r * 65536).int(),
                              off_y.int(), x0f.int(), window, C, fidx.int())
    assert torch.equal(got, want)


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


def test_kernels_reject_wrong_inputs(dev):
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        wk.crop_frac(torch.zeros((1, 128, 384), device=dev), z, z, torch.ones(1, device=dev),
                     z, z, 128, 3)
    with pytest.raises(ValueError):
        wk.crop_frac(torch.zeros((1, 128, 384), device=dev, dtype=torch.bfloat16), z, z,
                     torch.ones(1), z, z, 128, 3)  # r on the CPU
