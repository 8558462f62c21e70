"""The port's FusedPipeline vs the JAX FusedPipeline at a small
configuration: serving 256², detection 128², fractional window 64, 64²
faces, EfficientNet-b0, float32, on frames with a rendered face.

The JAX side runs its Pallas windowed warp in interpret mode (patched in
the way tests/test_e2e.py does); the port runs its kernels' plain
versions. Both read the committed SCRFD weights, so the best face is a
clear argmax. Tolerances:

- ``has_face`` identical; ``bbox``/``landmarks`` within 1e-2 px (float32
  convs in two frameworks, then ×2 to serving pixels);
- ``fake_prob`` within 0.02: the two warps differ by at most one bf16 tap
  step at a few pixels (XLA's CPU compiler forms FMAs and keeps bf16
  products in float32 that the kernels round) and the jitted JAX geometry
  may land ``r`` one 2⁻¹⁶ step apart, which moves the classifier's input
  by about a grey level;
- ``quality`` within 1e-2 for the same reason.
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
from deepfake_vit_tpu.ops.warp import warp_affine_windowed
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables, to_numpy_tree
from deepfake_vit_tpu_torch.preprocessing.detector import FaceDetector, default_weights_path

torch.set_num_threads(1)

CLASSIFIER = "deepfake_vit_tpu/weights/classifier_synface.msgpack"
COMMON = dict(detection_input_size=(128, 128), serving_size=(256, 256), output_size=(64, 64),
              warp_window=64, warp_fractional=True, confidence_threshold=0.0)


def _cfg(hidden):
    return {"model": {"feature_extractor": {"variant": "b0", "dropout_rate": 0.0},
                      "classifier": {"hidden_dims": hidden, "num_classes": 2}}}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return np.stack([render_scene(rng, size=256, max_faces=1, p_empty=0.0, min_face=60,
                                  max_face=140)[0] for _ in range(4)])


@pytest.mark.parametrize("classifier", ["trained_b0_512_128_32", "seeded_b0_16"])
def test_pipeline_matches_jax(frames, monkeypatch, classifier):
    with open(default_weights_path("scrfd"), "rb") as f:
        det_vars = flax.serialization.msgpack_restore(f.read())
    if classifier.startswith("trained"):
        cfg = _cfg([512, 128, 32])
        with open(CLASSIFIER, "rb") as f:
            ck = flax.serialization.msgpack_restore(f.read())
        model_vars = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    else:
        cfg = _cfg([16])
        model_vars = None

    jpipe = je2e.FusedPipeline(cfg, dtype=jnp.float32, **COMMON)
    if model_vars is None:
        model_vars = jax.jit(jpipe.model.init)(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 5, 2)))
    monkeypatch.setattr(je2e, "warp_affine_windowed", partial(warp_affine_windowed, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.device_get(jax.jit(jpipe._graph)(det_vars, model_vars, jnp.asarray(frames)))

    pipe = FusedPipeline(cfg, dtype=torch.float32, device="cpu", **COMMON)
    pipe.load_variables(seed=0)  # the committed SCRFD weights, read by the port's reader
    load_flax_variables(pipe.model, to_numpy_tree(model_vars))
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}

    assert set(out) == set(ref)
    for k in out:
        assert out[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    assert ref["confidence"].min() > 0.9, "rendered faces give a clear best face"
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=1e-2)
    np.testing.assert_allclose(out["landmarks"], ref["landmarks"], atol=1e-2)
    np.testing.assert_allclose(out["confidence"], ref["confidence"], atol=1e-5)
    np.testing.assert_allclose(out["quality"], ref["quality"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=0.02)
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, rtol=1e-5)


def test_fused_backbone_pipeline_matches_jax(frames, monkeypatch):
    """``use_fused_backbone=True`` on the CPU: the port runs the fused stages'
    plain versions (stem and blocks 0-2 in bf16, BatchNorm folded), the JAX
    pipeline falls back to its unfused backbone off the TPU — the reference
    the fused path is itself held to. ``fake_prob`` within 0.03: the bf16
    early stages on top of the warp's differences."""
    with open(default_weights_path("scrfd"), "rb") as f:
        det_vars = flax.serialization.msgpack_restore(f.read())
    with open(CLASSIFIER, "rb") as f:
        ck = flax.serialization.msgpack_restore(f.read())
    model_vars = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    cfg = _cfg([512, 128, 32])

    jpipe = je2e.FusedPipeline(cfg, dtype=jnp.float32, use_fused_backbone=True, **COMMON)
    assert not jpipe.use_fused_backbone  # switched off: not a TPU
    monkeypatch.setattr(je2e, "warp_affine_windowed", partial(warp_affine_windowed, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.device_get(jax.jit(jpipe._graph)(det_vars, model_vars, jnp.asarray(frames)))

    pipe = FusedPipeline(cfg, dtype=torch.float32, device="cpu", use_fused_backbone=True, **COMMON)
    pipe.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    assert pipe.use_fused_backbone and pipe._fused.tail_start == 3
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}
    plain = FusedPipeline(cfg, dtype=torch.float32, device="cpu", **COMMON)
    plain.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    unfused = {k: v.numpy() for k, v in plain.forward(frames).items()}

    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=1e-2)
    np.testing.assert_allclose(out["landmarks"], ref["landmarks"], atol=1e-2)
    np.testing.assert_allclose(out["quality"], ref["quality"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=0.03)
    # The fused stages really ran: the features differ from the unfused
    # port's, by bf16 roundings only.
    assert not np.array_equal(out["features"], unfused["features"])
    np.testing.assert_allclose(out["fake_prob"], unfused["fake_prob"], atol=0.03)
    scale = np.abs(unfused["features"]).max()
    np.testing.assert_allclose(out["features"], unfused["features"], atol=0.05 * scale)


def test_predict_clip_and_checkpoint_loading(frames):
    pipe = FusedPipeline(_cfg([512, 128, 32]), dtype=torch.float32, device="cpu", **COMMON)
    pipe.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    res = pipe.predict_clip(frames)
    assert res["num_faces"] == 4 and len(res["frame_probs"]) == 4
    assert 0.0 <= res["fake_prob"] <= 1.0 and res["label"] in (0, 1)
    np.testing.assert_allclose(res["fake_prob"], np.mean(res["frame_probs"]), rtol=1e-6)


def test_entry_point_device_and_unported_options(monkeypatch):
    cfg = _cfg([16])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedPipeline(cfg, **COMMON)  # no card and no explicit CPU: never a silent fallback
    with pytest.raises(ValueError, match="mtcnn"):  # MTCNN-Lite has no pooled stem
        FusedPipeline(cfg, device="cpu", detector_arch="mtcnn", **COMMON)
    assert FaceDetector(refine=True, input_size=(96, 96), device="cpu").refiner is not None
    ratio1 = {**COMMON, "detection_input_size": COMMON["serving_size"]}
    assert FusedPipeline(cfg, device="cpu", detector_arch="mtcnn", **ratio1).detector_arch == "mtcnn"
    with pytest.raises(ValueError, match="scrfd family"):
        FusedPipeline(cfg, device="cpu", use_int8_detector=True, detector_arch="lite", **COMMON)
    with pytest.raises(ValueError, match="warp_tap_mode"):
        FusedPipeline(cfg, device="cpu", warp_tap_mode="uw8", **COMMON)
    for option in (dict(use_int8_tail=True), dict(use_int8_detector=True),
                   dict(warp_fractional=False), dict(use_fused_backbone=True),
                   dict(keep_top_k=3), dict(warp_tap_mode="uw16"), dict(warp_tap_mode="uw"),
                   dict(warp_tap_mode="int8"), dict(detector_arch="lite"),
                   dict(use_s2d_early=True)):  # ported: these construct
        FusedPipeline(cfg, device="cpu", **{**COMMON, **option})
    multi = FusedPipeline(cfg, device="cpu", keep_top_k=3, detector_arch="lite", **COMMON)
    assert (multi.keep_top_k, multi.nms_threshold, multi.detector_arch) == (3, 0.4, "lite")
    fused = FusedPipeline(cfg, device="cpu", use_fused_backbone=True, **COMMON)
    assert fused.use_fused_backbone  # never switched off silently, whatever the device
    fused.init_variables(0)
    assert fused._fused is not None and fused._fused.tail_start == 3  # b0 at 64²: 32² and 16² maps
    s2d = FusedPipeline(cfg, device="cpu", use_s2d_early=True, **COMMON)
    s2d.init_variables(0)
    assert s2d._s2d is not None and s2d._s2d.resume_block == 2  # b0: stem, blocks 0 and 1
    pipe = FusedPipeline(cfg, device="cpu", **COMMON)
    with pytest.raises(RuntimeError, match="init_variables"):
        pipe.forward(np.zeros((1, 256, 256, 3), np.uint8))
