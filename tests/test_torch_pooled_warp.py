"""The port's pooled (non-fractional) windowed warp vs the JAX package's.

- ``max_window_levels`` and ``window_geometry``: level and offsets decide
  which pixels a crop reads and must be EXACTLY the JAX function's,
  evaluated eagerly (under jit XLA's CPU compiler contracts ``a·x + b`` into
  FMAs, which the function's own definition does not); ``A_win`` gets a few
  float32 ulps.
- ``crop_pool`` (its plain version, as the wrapper runs it on CPU tensors)
  vs the Pallas kernel in interpret mode, compiled without XLA's excess
  precision so that it rounds to bf16 where the TPU does. Integer-valued
  pixels: the f32 sums of up to four terms are exact in any order, so the
  result is bitwise equal. General bf16 pixels: the order of the sums may
  move a result by one bf16 step (1.0 below 256). Level 0 is a pure crop.
- the windowed warp and the whole pipeline with its default warp arguments
  against the JAX Pallas path in interpret mode, with the tolerances of
  tests/test_torch_warp_kernels.py and tests/test_torch_e2e.py.
"""

from functools import partial

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deepfake_vit_tpu.e2e as je2e
from deepfake_vit_tpu.data.synth_faces import render_scene
from deepfake_vit_tpu.ops import warp as jwarp
from deepfake_vit_tpu.ops.pallas import warp_kernel as jk
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.ops import warp as twarp
from deepfake_vit_tpu_torch.ops import warp_kernel as tk
from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path

torch.set_num_threads(1)

CLASSIFIER = "deepfake_vit_tpu/weights/classifier_synface.msgpack"


def _t(x):
    return torch.from_numpy(np.array(x))


def _interpret(fn, *args):
    """Run ``fn`` in Pallas interpret mode, compiled without excess precision."""
    with pltpu.force_tpu_interpret_mode():
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return jax.device_get(compiled(*args))


def _similarities(rng, n, out, scale, center):
    s = np.exp(rng.uniform(np.log(scale[0]), np.log(scale[1]), n))
    th = rng.uniform(-0.4, 0.4, n)
    R = s[:, None, None] * np.stack(
        [np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], 1)
    c = rng.uniform(*center, (n, 2))
    t = c - np.einsum("nij,j->ni", R, np.asarray([(out[1] - 1) / 2, (out[0] - 1) / 2]))
    return np.concatenate([R, t[..., None]], -1).astype(np.float32)


@pytest.mark.parametrize("src_hw,window", [((640, 640), 160), ((256, 256), 64), ((128, 192), 32),
                                           ((320, 320), 160), ((360, 640), 160), ((100, 100), 160)])
def test_max_window_levels_matches(src_hw, window):
    assert twarp.max_window_levels(src_hw, window) == jwarp.max_window_levels(src_hw, window)


@pytest.mark.parametrize("y_align", [8, 16])
def test_window_geometry_exact(y_align):
    rng = np.random.default_rng(4)
    H, W, window, out = 256, 320, 64, (64, 64)
    A = _similarities(rng, 96, out, scale=(0.2, 5.0), center=(-20.0, 300.0))
    levels = jwarp.max_window_levels((H, W), window)
    assert levels == 3
    gj = jwarp.window_geometry(jnp.asarray(A), out, (H, W), window, levels, y_align=y_align)
    gt = twarp.window_geometry(_t(A), out, (H, W), window, levels, y_align=y_align)
    assert set(np.asarray(gj[0]).tolist()) == {0, 1, 2}, "every level covered"
    for name, a, b in zip(("level", "y0s", "x0s"), gj[:3], gt[:3]):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_allclose(gt[3].numpy(), np.asarray(gj[3]), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["integer", "integer_shared_frames", "general", "general_mxu"])
def test_crop_pool_matches_pallas(case):
    """The shapes of tests/test_pallas_warp.py's pooled-crop test: three
    levels, offsets up to the frame's edge; ``shared``: six crops read two
    frames through frame_idx. One port kernel serves both TPU constructions."""
    B, H, W, C, window, levels = 6, 128, 192, 3, 32, 3
    level = np.asarray([0, 1, 2, 0, 1, 2], np.int32)
    y0 = np.asarray([0, 16, 0, 96, 32, 0], np.int32)  # selected-level offsets
    x0 = np.asarray([0, 17, 8, 160, 5, 16], np.int32)
    y0_l0 = y0 << level
    rng = np.random.default_rng(1)
    shared = case.endswith("shared_frames")
    n_frames = 2 if shared else B
    if case.startswith("integer"):
        img = rng.integers(0, 256, (n_frames, H, W * C)).astype(np.float32)
    else:
        img = rng.uniform(0, 255, (n_frames, H, W * C)).astype(np.float32)
    fidx = (np.arange(B, dtype=np.int32) % n_frames) if shared else None
    construction = "mxu" if case.endswith("mxu") else "legacy"

    ref = np.asarray(_interpret(
        lambda f, y, x, lv: jk.crop_window_pool_pallas(
            f, y, x, lv, window, C, levels, y_align=16,
            frame_idx=None if fidx is None else jnp.asarray(fidx),
            construction=construction).astype(jnp.float32),
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(y0_l0), jnp.asarray(x0), jnp.asarray(level)))
    frames = _t(img).to(torch.bfloat16)
    port = tk.crop_pool(frames, _t(y0_l0), _t(x0), _t(level), window, C,
                        frame_idx=None if fidx is None else _t(fidx)).float().numpy()
    assert port.shape == ref.shape == (B, window, window * C)
    if case.startswith("integer"):
        np.testing.assert_array_equal(port, ref)
    else:
        assert np.abs(port - ref).max() <= 1.0  # one bf16 step below 256
        assert np.mean(port != ref) < 0.01
    # Level 0 is a pure crop of the bf16 frame: bitwise.
    src = frames.float().numpy().reshape(n_frames, H, W, C)
    for n in np.nonzero(level == 0)[0]:
        f = n if fidx is None else fidx[n]
        np.testing.assert_array_equal(port[n].reshape(window, window, C),
                                      src[f, y0[n]:y0[n] + window, x0[n]:x0[n] + window])
    # Against the definition: l applications of the 2×2 mean, then the crop
    # (float32, no intermediate rounding): within one bf16 step.
    pyr = torch.from_numpy(src)
    for l in range(levels):
        for n in np.nonzero(level == l)[0]:
            f = n if fidx is None else fidx[n]
            want = pyr[f, y0[n]:y0[n] + window, x0[n]:x0[n] + window].numpy()
            assert np.abs(port[n].reshape(window, window, C) - want).max() <= 1.0
        pyr = twarp._avg_pool2(pyr)


def test_crop_pool_wrapper_validates_and_counts_only_launches():
    frames = torch.zeros((1, 32, 96))
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.crop_pool(frames, z, z, z, 16, 3)
    with pytest.raises(ValueError):
        tk.crop_pool(frames.to(torch.bfloat16), z, z, torch.zeros(2, dtype=torch.int32), 16, 3)
    before = tk.crop_pool.launches
    out = tk.crop_pool(frames.to(torch.bfloat16), z, z, z, 16, 3)
    assert out.shape == (1, 16, 48) and tk.crop_pool.launches == before  # the CPU launches nothing


def test_pooled_windowed_warp_matches_pallas_path():
    """warp_affine_windowed(fractional=False): geometry, pooled crop and warp
    composed, port vs the JAX Pallas path. Both stages are in the bf16
    class: a pixel may move by one step at each (the jitted JAX geometry may
    also contract to FMAs), so 2.0 on the 0–255 scale, and most values equal."""
    rng = np.random.default_rng(3)
    B, S, window, out = 6, 256, 64, (24, 24)
    img = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    A = _similarities(rng, B, out, scale=(0.3, 4.5), center=(40.0, 216.0))
    levels = twarp.max_window_levels((S, S), window)
    level = twarp.window_geometry(_t(A), out, (S, S), window, levels, y_align=16)[0]
    assert levels == 3 and len(set(level.tolist())) == 3, "every level used"
    ref = np.asarray(_interpret(
        lambda im, m: jwarp.warp_affine_windowed(im, m, out, window=window, use_pallas=True,
                                                 inverse=True),
        jnp.asarray(img), jnp.asarray(A)))
    port = twarp.warp_affine_windowed(_t(img), _t(A), out, window=window, inverse=True).numpy()
    assert port.shape == ref.shape == (B, *out, 3)
    np.testing.assert_allclose(port, ref, atol=2.0)
    assert np.mean(port == ref) > 0.9
    with pytest.raises(ValueError, match="levels"):
        twarp.warp_affine_windowed(_t(img), _t(A), out, window=window, fractional=True, levels=2)


def test_default_warp_pipeline_matches_jax(monkeypatch):
    """FusedPipeline with its default warp arguments (pooled window; 64 here
    for 256² frames), float32, trained b0 classifier, against the JAX
    pipeline with its Pallas warp patched in (interpret mode). Tolerances
    and their reasons as in tests/test_torch_e2e.py."""
    with open(default_weights_path("scrfd"), "rb") as f:
        det_vars = flax.serialization.msgpack_restore(f.read())
    with open(CLASSIFIER, "rb") as f:
        ck = flax.serialization.msgpack_restore(f.read())
    model_vars = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    cfg = {"model": ck["model_config"]}
    common = dict(detection_input_size=(128, 128), serving_size=(256, 256), output_size=(64, 64),
                  warp_window=64, confidence_threshold=0.0)
    rng = np.random.default_rng(3)
    frames = np.stack([render_scene(rng, size=256, max_faces=1, p_empty=0.0, min_face=60,
                                    max_face=200)[0] for _ in range(3)])

    jpipe = je2e.FusedPipeline(cfg, dtype=jnp.float32, **common)
    assert jpipe.warp_fractional is False
    monkeypatch.setattr(je2e, "warp_affine_windowed",
                        partial(jwarp.warp_affine_windowed, use_pallas=True))
    ref = _interpret(jpipe._graph, det_vars, model_vars, jnp.asarray(frames))

    pipe = FusedPipeline(cfg, dtype=torch.float32, device="cpu", **common)
    assert pipe.warp_fractional is False and pipe._windowed
    pipe.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}

    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    assert ref["confidence"].min() > 0.9, "rendered faces give a clear best face"
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=1e-2)
    np.testing.assert_allclose(out["landmarks"], ref["landmarks"], atol=1e-2)
    np.testing.assert_allclose(out["confidence"], ref["confidence"], atol=1e-5)
    np.testing.assert_allclose(out["quality"], ref["quality"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=0.02)
