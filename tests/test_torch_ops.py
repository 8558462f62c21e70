"""PyTorch port vs JAX package: the batched ops of the serving path.

Inputs are made with numpy from a seed and handed to both packages. The
ops are float32 elementwise/reduction code; tolerances are a few float32
ulps scaled to each quantity unless exact equality is the contract.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_vit_tpu.ops import anchors as janchors
from deepfake_vit_tpu.ops import gaussian as jgauss
from deepfake_vit_tpu.ops import image as jimage
from deepfake_vit_tpu.ops import quality as jquality
from deepfake_vit_tpu.ops import warp as jwarp

# deepfake_vit_tpu.ops re-exports a function named umeyama over the module.
jumeyama = importlib.import_module("deepfake_vit_tpu.ops.umeyama")
from deepfake_vit_tpu_torch.ops import anchors as tanchors
from deepfake_vit_tpu_torch.ops import gaussian as tgauss
from deepfake_vit_tpu_torch.ops import image as timage
from deepfake_vit_tpu_torch.ops import quality as tquality
from deepfake_vit_tpu_torch.ops import umeyama as tumeyama
from deepfake_vit_tpu_torch.ops import warp as twarp

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _similarities(rng, n, scale=(0.3, 5.0), center=(-20.0, 260.0)):
    s = rng.uniform(*scale, n)
    th = rng.uniform(-0.4, 0.4, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    t = rng.uniform(*center, (n, 2, 1))
    return np.concatenate([R, t], -1).astype(np.float32)


def test_anchors_and_decode_match():
    rng = np.random.default_rng(0)
    cj, sj = janchors.all_anchor_centers((128, 96))
    ct, st = tanchors.all_anchor_centers((128, 96))
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(sj, st)
    dist = rng.uniform(0, 4, (2, cj.shape[0], 4)).astype(np.float32)
    kps = rng.uniform(-3, 3, (2, cj.shape[0], 10)).astype(np.float32)
    # Same float32 multiply/add sequence: exact.
    np.testing.assert_array_equal(
        np.asarray(janchors.decode_boxes(jnp.asarray(cj), jnp.asarray(sj), jnp.asarray(dist))),
        tanchors.decode_boxes(_t(ct), _t(st), _t(dist)).numpy())
    np.testing.assert_array_equal(
        np.asarray(janchors.decode_landmarks(jnp.asarray(cj), jnp.asarray(sj), jnp.asarray(kps))),
        tanchors.decode_landmarks(_t(ct), _t(st), _t(kps)).numpy())


def test_umeyama_closed_form_matches_svd():
    """The port's 2-D closed form vs the JAX SVD solve, on noisy landmark
    sets including reflected ones (det < 0 exercises the reflection guard).
    Tolerance 1e-4 relative: both are float32 solves of the same problem."""
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 640, (64, 5, 2)).astype(np.float32)
    A = _similarities(rng, 64, scale=(0.2, 3.0), center=(-50, 300))
    dst = np.einsum("nij,nkj->nki", A[:, :, :2], src) + A[:, None, :, 2]
    dst = (dst + rng.normal(0, 2.0, dst.shape)).astype(np.float32)
    dst[:8, :, 0] *= -1.0  # reflections
    aj = np.asarray(jumeyama.umeyama(jnp.asarray(src), jnp.asarray(dst)))
    at = tumeyama.umeyama(_t(src), _t(dst)).numpy()
    np.testing.assert_allclose(at[:, :, :2], aj[:, :, :2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(at[:, :, 2], aj[:, :, 2], rtol=1e-4, atol=2e-3)

    np.testing.assert_allclose(tumeyama.invert_affine(_t(aj)).numpy(),
                               np.asarray(jumeyama.invert_affine(jnp.asarray(aj))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tumeyama.transform_points(_t(aj), _t(src)).numpy(),
                               np.asarray(jumeyama.transform_points(jnp.asarray(aj), jnp.asarray(src))),
                               rtol=1e-6, atol=1e-3)


def _degenerate_landmarks(case, rng):
    src = rng.uniform(0, 200, (4, 5, 2)).astype(np.float32)
    dst = rng.uniform(0, 200, (4, 5, 2)).astype(np.float32)
    if case == "collinear_src":  # rank-1 covariance
        u = rng.uniform(-50, 50, (4, 5, 1))
        src = (np.asarray([100.0, 80.0]) + u * np.asarray([0.8, 0.6])).astype(np.float32)
    elif case == "coincident_src":  # zero covariance and zero source variance
        # Integer-valued so the mean is exact and the deviations are exactly
        # 0. With a mean that rounds, both solves divide float32 rounding
        # noise by noise and land on different, equally meaningless affines.
        src[:] = np.round(src[:, :1])
    elif case == "coincident_dst":  # zero covariance
        dst[:] = dst[:, :1]
    elif case == "mirrored_square":  # covariance diag(-k, k): every rotation ties
        sq = np.asarray([[-1, -1], [1, -1], [1, 1], [-1, 1], [0, 0]], np.float32) * 30
        src = np.broadcast_to(sq + 100, (4, 5, 2)).copy()
        dst = (sq * np.asarray([-1, 1], np.float32) + 50).astype(np.float32)[None].repeat(4, 0)
    return src, dst


@pytest.mark.parametrize("case", ["collinear_src", "coincident_src", "coincident_dst",
                                  "mirrored_square"])
def test_umeyama_degenerate_covariance_matches_svd(case):
    """Degenerate landmark sets, where the SVD's rotation is not unique or
    the scale is 0: the closed form must give the same affine as the JAX
    SVD solve (scale 0 makes the rotation irrelevant). Tolerance 1e-4
    relative, 1e-3 px absolute on the translation: float32 solves."""
    src, dst = _degenerate_landmarks(case, np.random.default_rng(2))
    aj = np.asarray(jumeyama.umeyama(jnp.asarray(src), jnp.asarray(dst)))
    at = tumeyama.umeyama(_t(src), _t(dst)).numpy()
    assert np.isfinite(at).all()
    np.testing.assert_allclose(at[:, :, :2], aj[:, :, :2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(at[:, :, 2], aj[:, :, 2], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("normalize",["global_max", "per_sample", "none"])
def test_landmark_gaussian_map(normalize):
    rng = np.random.default_rng(2)
    lms = rng.uniform(0, 224, (3, 5, 2)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    kw = dict(weights=None, normalize=normalize)
    for weights in (None, w):
        kw["weights"] = weights
        mj = np.asarray(jgauss.landmark_gaussian_map(
            jnp.asarray(lms), (6, 7), **{**kw, "weights": None if weights is None else jnp.asarray(weights)}))
        mt = tgauss.landmark_gaussian_map(
            _t(lms), (6, 7), **{**kw, "weights": None if weights is None else _t(weights)}).numpy()
        np.testing.assert_allclose(mt, mj, rtol=1e-5, atol=1e-6)


def test_image_ops_and_quality():
    """Quality scores on random faces: float32 reductions over 64² images
    summed in a different order — 1e-4 relative; validity exact."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (4, 64, 64, 3)).astype(np.float32)
    img[1] *= 0.1  # dark, low-contrast face
    lms = rng.uniform(-10, 74, (4, 5, 2)).astype(np.float32)  # some windows clipped / empty
    lms[0, 0] = (-30.0, -30.0)
    bbox = np.asarray([[0, 0, 60, 70], [5, 5, 40, 45], [0, 0, 600, 700], [1, 2, 120, 150]], np.float32)
    conf = rng.uniform(0, 1, 4).astype(np.float32)

    gj = jimage.rgb_to_gray(jnp.asarray(img))
    gt = timage.rgb_to_gray(_t(img))
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    np.testing.assert_allclose(timage.laplacian(gt).numpy(), np.asarray(jimage.laplacian(gj)),
                               rtol=1e-6, atol=1e-4)

    oj, vj, rj = jquality.overall_quality(jnp.asarray(img), jnp.asarray(lms), jnp.asarray(bbox),
                                          jnp.asarray(conf))
    ot, vt, rt = tquality.overall_quality(_t(img), _t(lms), _t(bbox), _t(conf))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for k in rj:
        np.testing.assert_allclose(rt[k].numpy().astype(np.float64), np.asarray(rj[k], np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_window_geometry_frac_exact():
    """The geometry decides which pixels a crop reads: level, strip0, r,
    off_y and x0f must be EXACTLY the JAX function's (evaluated eagerly —
    under jit XLA's CPU compiler contracts a·x + b into FMAs, which the
    function's own definition does not)."""
    rng = np.random.default_rng(4)
    H, W, window, out = 256, 320, 64, (64, 64)
    A = _similarities(rng, 96, scale=(0.2, 4.0))
    A[:8, :, :2] = np.eye(2, dtype=np.float32) * 0.3  # r == 1, bucket 0
    levels = jwarp.frac_window_levels(H, window)
    assert levels == twarp.frac_window_levels(H, window)
    gj = jwarp.window_geometry_frac(jnp.asarray(A), out, (H, W), window, levels, y_align=16)
    gt = twarp.window_geometry_frac(_t(A), out, (H, W), window, levels, y_align=16)
    assert len(set(np.asarray(gj[0]).tolist())) == levels, "every bucket covered"
    assert (np.asarray(gj[2]) == 1.0).sum() >= 8
    for name, a, b in zip(("level", "strip0s", "r", "off_y", "x0f"), gj[:5], gt[:5]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_allclose(gt[5].numpy(), np.asarray(gj[5]), rtol=1e-6, atol=1e-5)


def test_exact_warp_affine_matches():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (3, 40, 48, 3)).astype(np.float32)
    A = _similarities(rng, 3, scale=(0.6, 1.4), center=(-5, 20))
    wj = np.asarray(jwarp.warp_affine(jnp.asarray(img), jnp.asarray(A), (32, 36)))
    wt = twarp.warp_affine(_t(img), _t(A), (32, 36)).numpy()
    # Float32 bilinear: ≤ a few ulps of 255.
    np.testing.assert_allclose(wt, wj, atol=2e-3)
