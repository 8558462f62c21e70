"""The port's tap constructions (plain versions, as the wrappers run them on
CPU tensors) vs the JAX package's Pallas kernels in interpret mode: the
crop's rank-1 "mxu" taps, the warp's rank-1 "uw"/"uw16" taps and its q7
"int8" taps.

The references are compiled without excess precision, as in
tests/test_torch_warp_kernels.py; XLA's CPU compiler still contracts
``a·j + b·i`` (and the crop's ``(o + 0.5)·r + off``) into FMAs, which the
TPU kernels' arithmetic does not, so a tap may land one rounding step
apart now and then. The rank-1 matmul itself is not contracted: XLA's CPU
dot computes ``127·sy + (127(1 − t) + 0.5)`` with the product rounded
before the sum (checked element by element against both roundings on 32k
random coordinates), which is how the port's int8 taps round.

- crop "mxu", warp "uw"/"uw16": within 1.5 on the 0–255 scale, under 1 %
  of values differing (one bf16 tap step on a pixel plus half an ulp);
  r = 1 faces bitwise; the port's "uw" and "uw16" bit for bit equal.
- warp "int8": within 2.5 grey levels, under 1 % of values differing (a
  one-step q7 tap flip moves a value by at most pixel/127 ≤ 2.0, and the
  bf16 rounding of P adds ≤ 0.25); exact zeros where the footprint is
  outside the source.
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
    """Run ``fn`` in Pallas interpret mode, compiled without excess
    precision; the result is fetched before anything else is dispatched."""
    with pltpu.force_tpu_interpret_mode():
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return np.asarray(jax.device_get(compiled(*args).astype(jnp.float32)))


def _assert_close(port, ref, tol):
    diff = np.abs(port - ref)
    assert diff.max() <= tol, f"max diff {diff.max()}"
    assert np.mean(diff > 0) < 0.01, f"{np.mean(diff > 0):.3%} of values differ"


def _affines(n, H, W, out, seed, s_range=(0.15, 3.0), overhang=30):
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(np.log(s_range[0]), np.log(s_range[1]), n))
    s[: n // 4] = 0.4  # quad fits the window at r = 1
    th = rng.uniform(-0.35, 0.35, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    center = rng.uniform(-overhang, max(H, W) + overhang, (n, 2))
    t = center - np.einsum("nij,j->ni", R, np.asarray([(out[1] - 1) / 2, (out[0] - 1) / 2]))
    return np.concatenate([R, t[..., None]], -1).astype(np.float32)


@pytest.mark.parametrize("frame_idx", [None, "shared"])
def test_crop_frac_mxu_matches_pallas(frame_idx):
    """Strip buckets 0–2, windows overhanging the frame, r = 1 faces and
    (``shared``) several faces reading one frame through frame_idx."""
    H, W, C, window, out, N = 256, 192, 3, 64, (48, 48), 12
    A = _affines(N, H, W, out, seed=0)
    levels = jwarp.frac_window_levels(H, window)
    level, strip0s, r, off_y, x0f, _ = jwarp.window_geometry_frac(
        jnp.asarray(A), out, (H, W), window, levels, y_align=16)
    assert set(np.asarray(level).tolist()) == set(range(levels)) and levels == 3
    exact = np.asarray(r) == 1.0
    assert exact.sum() >= 3
    strip0 = strip0s[level, jnp.arange(N)]
    B = 4 if frame_idx else N
    img = np.random.default_rng(1).uniform(0, 255, (B, H, W * C)).astype(np.float32)
    fidx = np.arange(N, dtype=np.int32) % B if frame_idx else None
    ref = _interpret(
        lambda f, s0, lv, rr, oy, x0: jk.crop_window_frac_pallas(
            f, s0, lv, rr, oy, x0, window, C, levels, y_align=16,
            frame_idx=None if fidx is None else jnp.asarray(fidx), construction="mxu"),
        jnp.asarray(img, jnp.bfloat16), strip0, level, r, off_y, x0f)
    args = [torch.from_numpy(np.array(v)) for v in (strip0, level, r, off_y, x0f)]
    frames = torch.from_numpy(img).to(torch.bfloat16)
    fi = None if fidx is None else torch.from_numpy(fidx)
    port = tk.crop_frac_mxu(frames, *args, window, C, frame_idx=fi).float().numpy()
    assert port.shape == ref.shape == (N, window, window * C)
    _assert_close(port, ref, 1.5)
    np.testing.assert_array_equal(port[exact], ref[exact])
    # At r = 1 both tap constructions copy the window exactly.
    legacy = tk.crop_frac(frames, *args, window, C, frame_idx=fi).float().numpy()
    np.testing.assert_array_equal(port[exact], legacy[exact])


def _warp_case(shape, out, seed, scale=(0.6, 1.6)):
    rng = np.random.default_rng(seed)
    B = shape[0]
    s = rng.uniform(*scale, B)
    th = rng.uniform(-0.4, 0.4, B)
    A = np.stack([np.concatenate(
        [k * np.asarray([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]),
         rng.uniform(-8, 8, (2, 1))], 1) for k, t in zip(s, th)]).astype(np.float32)
    A[0, 0, 2] = 25.0  # part of the output samples left of the source
    return A


# 60×72: not a multiple of 16 (the TPU kernel pads uw/uw16 sources to 16
# rows and columns and int8 sources to 32); 40×56 also crosses 32 in width.
WARP_SHAPES = [((2, 60, 72, 3), (32, 32)), ((3, 40, 56, 3), (48, 40))]


@pytest.mark.parametrize("shape,out", WARP_SHAPES)
def test_warp_uw_and_uw16_match_pallas(shape, out):
    img = np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32)
    A = _warp_case(shape, out, seed=3)
    got = {}
    for mode in ("uw", "uw16"):
        ref = _interpret(lambda im, m: jk.warp_affine_pallas(im, m, out, construction=mode),
                         jnp.asarray(img), jnp.asarray(A))
        fn = tk.warp_affine_uw if mode == "uw" else tk.warp_affine_uw16
        got[mode] = fn(torch.from_numpy(img), torch.from_numpy(A), out).numpy()
        assert got[mode].shape == ref.shape == (shape[0], *out, shape[3])
        _assert_close(got[mode], ref, 1.5)
    np.testing.assert_array_equal(got["uw"], got["uw16"])
    assert (got["uw"] == 0).any(), "some output pixels fall outside the source"


@pytest.mark.parametrize("shape,out", WARP_SHAPES)
@pytest.mark.parametrize("pixels", ["integer", "bf16"])
def test_warp_int8_matches_pallas(shape, out, pixels):
    """``bf16``: a non-integer bf16 source, as the fractional crop gives at
    r ≠ 1, so the s8 quantization's half-to-even rounding is exercised."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    img = np.round(img) if pixels == "integer" else np.array(
        jnp.asarray(img, jnp.bfloat16).astype(jnp.float32))
    if pixels == "bf16":
        img[0, :4, :4] = np.asarray([[0.5, 1.5, 2.5, 127.5]], np.float32)[..., None]
    A_inv = _warp_case(shape, out, seed=5)  # dst→src
    ref = _interpret(
        lambda im, m: jk.warp_affine_pallas(im, m, out, inverse=True, construction="int8"),
        jnp.asarray(img), jnp.asarray(A_inv))
    port = tk.warp_affine_int8(torch.from_numpy(img), torch.from_numpy(A_inv), out,
                               inverse=True).numpy()
    assert port.shape == ref.shape
    _assert_close(port, ref, 2.5)
    np.testing.assert_array_equal(port == 0, ref == 0)
    # The plain version is what the wrapper runs on the CPU.
    np.testing.assert_array_equal(tk.warp_affine_int8_plain(
        torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(A_inv).reshape(-1, 6), out
    ).numpy(), port)


def test_warp_int8_border_is_exact_zero():
    """A shift that pushes part of the output outside the source gives exact
    zeros there, as tests/test_pallas_warp.py checks of the JAX kernel: the
    s8 shift's correction must not leak into the border."""
    img = np.full((1, 48, 48, 3), 200.0, np.float32)
    A = np.asarray([[[1.0, 0.0, -30.0], [0.0, 1.0, 0.0]]], np.float32)
    ref = _interpret(lambda im, m: jk.warp_affine_pallas(im, m, (48, 48), construction="int8"),
                     jnp.asarray(img), jnp.asarray(A))
    port = tk.warp_affine_int8(torch.from_numpy(img), torch.from_numpy(A), (48, 48)).numpy()
    assert port[0, :, -5:, :].max() == 0.0 and ref[0, :, -5:, :].max() == 0.0
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("fractional", [True, False])
@pytest.mark.parametrize("mode", ["uw16", "int8"])
def test_windowed_warp_tap_modes_match_pallas_path(fractional, mode):
    """warp_affine_windowed(tap_construction=...): crop ("mxu" when
    fractional) and the mode's warp kernel composed, port vs the JAX Pallas
    path, K = 2 faces sharing each frame through frame_indices."""
    rng = np.random.default_rng(6)
    B, S, window, out = 2, 128, 32, (24, 24)
    img = rng.integers(0, 256, (B, S, S, 3)).astype(np.float32)
    A = _affines(2 * B, S, S, out, seed=7, s_range=(0.3, 1.5), overhang=-40)
    fidx = np.repeat(np.arange(B, dtype=np.int32), 2)
    ref = _interpret(
        lambda im, m, fi: jwarp.warp_affine_windowed(
            im, m, out, window=window, fractional=fractional, use_pallas=True, inverse=True,
            frame_indices=fi, tap_construction=mode),
        jnp.asarray(img), jnp.asarray(A), jnp.asarray(fidx))
    port = twarp.warp_affine_windowed(
        torch.from_numpy(img), torch.from_numpy(A), out, window=window, fractional=fractional,
        inverse=True, frame_indices=torch.from_numpy(fidx), tap_construction=mode).numpy()
    assert port.shape == ref.shape == (2 * B, *out, 3)
    # Window and warp in their error classes: a value may move by a tap
    # step at each of the two stages.
    np.testing.assert_allclose(port, ref, atol=2.5 if mode == "int8" else 2.0)
    assert np.mean(port == ref) > 0.9


def test_warp_affine_auto_takes_the_construction():
    """The non-windowed branch's warp: each construction reaches its own
    kernel's plain version on the CPU; unknown names raise."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.integers(0, 256, (2, 40, 40, 3)).astype(np.float32))
    A_inv = torch.from_numpy(_warp_case((2, 40, 40, 3), (24, 24), seed=9))
    for mode, plain in (("legacy", tk.warp_affine_legacy_plain), ("uw", tk.warp_affine_uw_plain),
                        ("uw16", tk.warp_affine_uw_plain), ("int8", tk.warp_affine_int8_plain)):
        got = twarp.warp_affine_auto(img, A_inv, (24, 24), inverse=True, tap_construction=mode)
        want = plain(img.to(torch.bfloat16), A_inv.reshape(2, 6), (24, 24))
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="tap construction"):
        twarp.warp_affine_auto(img, A_inv, (24, 24), tap_construction="uw8")
