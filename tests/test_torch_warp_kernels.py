"""The port's crop and warp (plain versions, as the wrappers run them on
CPU tensors) vs the JAX package's Pallas kernels in interpret mode.

The Pallas reference runs through XLA's CPU compiler, which by default
keeps bf16 intermediates in float32 ("excess precision") and contracts
``a·j + b·i`` into an FMA; the TPU kernel rounds at each step, as the port
does. The reference is therefore compiled with
``xla_allow_excess_precision=False``; the FMA contraction still moves a
tap weight by one bf16 rounding step now and then. Such a move shifts a
value by at most one tap step times a pixel (2⁻⁸·255 ≈ 1.0) plus half a
bf16 ulp of the rounded result, so the tolerance is 1.5 on the 0–255
scale, and such moves must stay rare (under 1% of values). Where the window is an identity resample (r = 1) the crop
must be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepfake_vit_tpu.ops import warp as jwarp
from deepfake_vit_tpu.ops.pallas import warp_kernel as jk
from deepfake_vit_tpu_torch.ops import warp as twarp
from deepfake_vit_tpu_torch.ops import warp_kernel as tk

torch.set_num_threads(1)


def _interpret(fn, *args):
    """Run ``fn`` in Pallas interpret mode, compiled without excess precision."""
    with pltpu.force_tpu_interpret_mode():
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return np.asarray(compiled(*args).astype(jnp.float32))


TOL = 1.5  # one bf16 tap step on a 0–255 pixel + half an ulp of the result


def _assert_close_to_pallas(port, ref):
    diff = np.abs(port - ref)
    assert diff.max() <= TOL, f"max diff {diff.max()}"
    assert np.mean(diff > 0) < 0.01, f"{np.mean(diff > 0):.3%} of values differ"


def _geometry(n, H, W, window, out, seed, frame_overhang=True):
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(np.log(0.15), np.log(3.0), n))
    s[: n // 4] = 0.4  # quad fits the window at r = 1
    th = rng.uniform(-0.35, 0.35, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    lo, hi = (-30, max(H, W) + 30) if frame_overhang else (40, min(H, W) - 40)
    center = rng.uniform(lo, hi, (n, 2))
    half = np.asarray([(out[1] - 1) / 2, (out[0] - 1) / 2])
    t = center - np.einsum("nij,j->ni", R, half)
    A = np.concatenate([R, t[..., None]], -1).astype(np.float32)
    levels = jwarp.frac_window_levels(H, window)
    geo = jwarp.window_geometry_frac(jnp.asarray(A), out, (H, W), window, levels, y_align=16)
    return A, levels, geo


@pytest.mark.parametrize("frame_idx", [None, "shared"])
def test_crop_frac_matches_pallas(frame_idx):
    """Strip buckets 0–2, r = 1 faces, windows overhanging the frame, and
    (``shared``) several faces reading one frame through frame_idx."""
    H, W, C, window, out = 256, 192, 3, 64, (48, 48)
    N = 12
    A, levels, (level, strip0s, r, off_y, x0f, _) = _geometry(N, H, W, window, out, seed=0)
    assert set(np.asarray(level).tolist()) == set(range(levels)) and levels == 3
    assert (np.asarray(r) == 1.0).sum() >= 3
    strip0 = strip0s[level, jnp.arange(N)]
    rng = np.random.default_rng(1)
    B = 4 if frame_idx else N
    img = rng.uniform(0, 255, (B, H, W * C)).astype(np.float32)
    fidx = np.arange(N, dtype=np.int32) % B if frame_idx else None
    frames = jnp.asarray(img, jnp.bfloat16)

    ref = _interpret(
        lambda f, s0, lv, rr, oy, x0: jk.crop_window_frac_pallas(
            f, s0, lv, rr, oy, x0, window, C, levels, y_align=16,
            frame_idx=None if fidx is None else jnp.asarray(fidx), construction="legacy"),
        frames, strip0, level, r, off_y, x0f)
    port = tk.crop_frac(
        torch.from_numpy(img).to(torch.bfloat16), *(torch.from_numpy(np.array(v)) for v in
                                                     (strip0, level, r, off_y, x0f)),
        window, C, frame_idx=None if fidx is None else torch.from_numpy(fidx),
    ).float().numpy()
    assert port.shape == ref.shape == (N, window, window * C)
    _assert_close_to_pallas(port, ref)
    exact = np.asarray(r) == 1.0
    np.testing.assert_array_equal(port[exact], ref[exact])
    # At r = 1 the crop is an identity resample of the frame's pixels.
    k = int(np.nonzero(exact)[0][0])
    src = img.reshape(B, H, W, C)[k if fidx is None else fidx[k]]
    y0 = int(strip0[k] + off_y[k])
    x0 = int(x0f[k])
    assert 0 <= y0 and y0 + window <= H and 0 <= x0 and x0 + window <= W
    np.testing.assert_array_equal(
        port[k].reshape(window, window, C),
        np.asarray(jnp.asarray(src[y0:y0 + window, x0:x0 + window], jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("shape,out", [((2, 32, 32, 3), (24, 24)), ((3, 40, 56, 3), (48, 40))])
def test_warp_affine_legacy_matches_pallas(shape, out):
    """Rotations, scales and border overhang (taps outside the source are 0)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    B = shape[0]
    s = rng.uniform(0.6, 1.6, B)
    th = rng.uniform(-0.4, 0.4, B)
    A = np.stack([np.concatenate(
        [k * np.asarray([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]),
         rng.uniform(-8, 8, (2, 1))], 1) for k, t in zip(s, th)]).astype(np.float32)
    A[0, 0, 2] = 25.0  # part of the output samples left of the source
    ref = _interpret(
        lambda im, m: jk.warp_affine_pallas(im, m, out, construction="legacy"),
        jnp.asarray(img), jnp.asarray(A))
    port = tk.warp_affine_legacy(torch.from_numpy(img), torch.from_numpy(A), out).numpy()
    assert port.shape == ref.shape == (B, *out, shape[3])
    _assert_close_to_pallas(port, ref)
    assert (port == 0).any(), "some output pixels fall outside the source"
    # And both sit within the bf16 error class of the exact float32 warp.
    exact = twarp.warp_affine(torch.from_numpy(img), torch.from_numpy(A), out).numpy()
    assert np.abs(port - exact).max() < 2.5


def test_windowed_warp_matches_pallas_path():
    """warp_affine_windowed(fractional=True): crop + warp kernels composed,
    port vs the JAX Pallas path, on identical geometry."""
    rng = np.random.default_rng(3)
    B, S, window, out = 4, 128, 32, (24, 24)
    img = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    A, _, _ = _geometry(B, S, S, window, out, seed=4, frame_overhang=False)
    ref = _interpret(
        lambda im, m: jwarp.warp_affine_windowed(im, m, out, window=window, fractional=True,
                                                 use_pallas=True, inverse=True),
        jnp.asarray(img), jnp.asarray(A))
    port = twarp.warp_affine_windowed(torch.from_numpy(img), torch.from_numpy(A), out,
                                      window=window, fractional=True, inverse=True).numpy()
    # Both window and warp in the bf16 class: a pixel may move by one ulp
    # at each of the two stages.
    np.testing.assert_allclose(port, ref, atol=2.0)
    assert np.mean(port == ref) > 0.9


def test_wrappers_validate_and_count_only_launches():
    frames = torch.zeros((1, 16, 48), dtype=torch.float32)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.crop_frac(frames, z, z, torch.ones(1), z, z, 16, 3)
    with pytest.raises(ValueError):
        tk.warp_affine_legacy(torch.zeros((2, 8, 8, 3)), torch.zeros((1, 2, 3)), (4, 4))
    with pytest.raises(TypeError):
        tk.crop_frac_mxu(frames, z, z, torch.ones(1), z, z, 16, 3)
    counted = (tk.crop_frac, tk.crop_frac_mxu, *tk.WARP_KERNELS.values())
    before = [k.launches for k in counted]
    tk.crop_frac(frames.to(torch.bfloat16), z, z, torch.ones(1), z, z, 16, 3)
    tk.crop_frac_mxu(frames.to(torch.bfloat16), z, z, torch.ones(1), z, z, 16, 3)
    for warp in tk.WARP_KERNELS.values():
        warp(torch.zeros((1, 8, 8, 3)), torch.eye(2, 3)[None], (4, 4))
    # The CPU runs the plain versions: no kernel launched, nothing counted.
    assert [k.launches for k in counted] == before
    # Every tap construction is ported now; an unknown one is an error.
    for mode in ("uw16", "int8"):
        out = twarp.warp_affine_windowed(torch.zeros((1, 64, 64, 3)), torch.eye(2, 3)[None],
                                         (8, 8), window=32, fractional=True, tap_construction=mode)
        assert out.shape == (1, 8, 8, 3)
    with pytest.raises(ValueError, match="tap construction"):
        twarp.warp_affine_windowed(torch.zeros((1, 64, 64, 3)), torch.eye(2, 3)[None], (8, 8),
                                   window=32, fractional=True, tap_construction="uw8")
