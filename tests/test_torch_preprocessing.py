"""The port's preprocessing front end (``preprocessing/``) vs the JAX
package's, on the CPU, with rendered faces (``data/synth_faces.py``).

- ``FaceAligner`` (similarity, affine, a nonzero border, windowed): the
  port's whole-frame warp is the kernel's plain version (bf16 taps), held
  to the JAX Pallas warp in interpret mode within ``TOL = 1.5`` on the
  0–255 scale (``tests/test_torch_warp_kernels.py``), a few per cent of
  the values differing at all, and to the JAX exact float32 warp (what
  the JAX aligner runs off the TPU) within 2.5, the bf16 class of
  ``tests/test_torch_warp_kernels.py`` (2.38 measured on these frames);
  the nonzero border runs the exact warp on both sides (within 0.05); the
  windowed warp within 2.0 of the JAX Pallas path (one bf16 step at each
  of its two stages). Transforms and aligned landmarks within 1e-3.
- The letterbox against ``cv2.resize(INTER_LINEAR)`` (the JAX
  ``_prepare``): at most one grey level (cv2 rounds 11-bit fixed-point
  weights), and equal where nothing is resized or the factor is exact.
- ``FaceDetector`` against the JAX ``FaceDetector`` (committed SCRFD
  weights): on canvas-sized frames bboxes and landmarks within 1e-2 px,
  confidence within 1e-3, ``num_faces`` identical; on frames that are
  resized, within 1.0 px (the letterbox's grey levels move the decode).
- ``QualityChecker``: scores within 1e-3 (relative), reasons identical.
- ``PreprocessingPipeline``: the fused batch and the modular stages give
  the same records; save / load round trip; statistics.
- ``configs.PREPROCESSING_CONFIG`` equals the JAX package's YAML file.
"""

from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

import deepfake_vit_tpu.ops.warp as jwarp
import deepfake_vit_tpu.preprocessing.aligner as jaligner
from deepfake_vit_tpu.data.synth_faces import render_scene
from deepfake_vit_tpu.ops.pallas.warp_kernel import warp_affine_pallas
from deepfake_vit_tpu.preprocessing import FaceDetector as JFaceDetector
from deepfake_vit_tpu.preprocessing.aligner import NormalizationProcessor as JNormalization
from deepfake_vit_tpu.preprocessing.quality_checker import QualityChecker as JQualityChecker
from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
from deepfake_vit_tpu_torch.ops.warp import warp_affine_auto
from deepfake_vit_tpu_torch.preprocessing.aligner import FaceAligner, NormalizationProcessor
from deepfake_vit_tpu_torch.preprocessing.detector import (FaceDetector, create_face_detector,
                                                           default_weights_path, letterbox)
from deepfake_vit_tpu_torch.preprocessing.pipeline import (PreprocessingOutput,
                                                           PreprocessingPipeline,
                                                           create_pipeline_from_config)
from deepfake_vit_tpu_torch.preprocessing.quality_checker import QualityChecker

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1.5  # one bf16 tap step on a 0–255 pixel + half an ulp (tests/test_torch_warp_kernels.py)
CANVAS = (160, 160)


def test_preprocessing_config_matches_yaml():
    with open(ROOT / "deepfake_vit_tpu" / "configs" / "preprocessing_config.yaml") as f:
        assert PREPROCESSING_CONFIG == yaml.safe_load(f)


@pytest.fixture(scope="module")
def scenes():
    """Canvas-sized frames with 1-2 rendered faces each, and the faces' true landmarks."""
    rng = np.random.default_rng(5)
    out = [render_scene(rng, size=CANVAS[0], max_faces=2, p_empty=0.0, min_face=40,
                        max_face=90) for _ in range(4)]
    return np.stack([o[0] for o in out]), np.stack([o[2][0] for o in out]).astype(np.float32)


@pytest.fixture(scope="module")
def det_vars():
    with open(default_weights_path("scrfd"), "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

def _pallas_auto(images, matrices, out_size, inverse=False, tap_construction="legacy"):
    return warp_affine_pallas(images, matrices, out_size, inverse=inverse,
                              construction=tap_construction)


def _jax_align(aligner, images, lms, monkeypatch, pallas: bool):
    """The JAX aligner's batch; ``pallas`` runs its warp through the Pallas
    kernels in interpret mode (the TPU's path) instead of the exact warp."""
    if pallas:
        monkeypatch.setattr(jaligner, "warp_affine_auto", _pallas_auto)
        orig = jwarp.warp_affine_windowed
        monkeypatch.setattr(jwarp, "warp_affine_windowed",
                            lambda *a, **k: orig(*a, use_pallas=True, **k))
    with pltpu.force_tpu_interpret_mode():
        args = (jnp.asarray(images, jnp.float32), jnp.asarray(lms, jnp.float32))
        compiled = jax.jit(aligner._align_graph).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return [np.asarray(a) for a in jax.device_get(compiled(*args))]


@pytest.mark.parametrize("case", ["similarity", "affine", "border", "windowed"])
def test_aligner_matches_jax(scenes, monkeypatch, case):
    frames, lms = scenes
    kw = {"similarity": {}, "affine": {"method": "affine"}, "border": {"border_value": 10.0},
          "windowed": {"warp_window": 64}}[case]
    if case == "border":  # the first face at the frame's corner: part of its output lies outside
        lms = lms.copy()
        lms[0] -= lms[0].min(axis=0) - 4.0
    out = (64, 64)
    got = FaceAligner(output_size=out, device="cpu", **kw).align_batch(frames, lms)
    exact = _jax_align(jaligner.FaceAligner(output_size=out, **kw), frames, lms, monkeypatch,
                       pallas=False)
    for g, r in zip(got[1:], exact[1:]):  # aligned landmarks, transforms
        np.testing.assert_allclose(g, r, atol=1e-3)
    if case == "border":  # both sides run the exact float32 warp
        np.testing.assert_allclose(got[0], exact[0], atol=0.05)
        assert (got[0] == 10.0).any(), "some output pixels fall outside the source"
        return
    pallas = _jax_align(jaligner.FaceAligner(output_size=out, **kw), frames, lms, monkeypatch,
                        pallas=True)
    diff = np.abs(got[0] - pallas[0])
    if case == "windowed":  # crop and warp: one bf16 step at each stage
        assert diff.max() <= 2.0 and np.mean(diff == 0) > 0.9
        np.testing.assert_allclose(got[0], exact[0], atol=2.0 + 2.5)
        return
    # XLA's FMA of a·j + b·i + c moves a bf16 tap weight by one rounding
    # step now and then (1.4 % of these values with the JAX transforms),
    # and the two solvers' transforms, about 1e-6 apart, move a few more.
    assert diff.max() <= TOL and np.mean(diff > 0) < 0.05, (diff.max(), np.mean(diff > 0))
    same = warp_affine_auto(torch.from_numpy(frames), torch.from_numpy(pallas[2]), out).numpy()
    same_diff = np.abs(same - pallas[0])
    assert same_diff.max() <= TOL and np.mean(same_diff > 0) < 0.03, np.mean(same_diff > 0)
    # Within the bf16 class of the exact float32 warp (tests/test_torch_warp_kernels.py).
    assert np.abs(got[0] - exact[0]).max() < 2.5


def test_aligner_host_api(scenes):
    frames, lms = scenes
    port = FaceAligner(output_size=(64, 64), device="cpu")
    jref = jaligner.FaceAligner(output_size=(64, 64))
    aligned, tform = port.align(frames[0], lms[0])
    batch = port.align_batch(frames[:1], lms[:1])
    np.testing.assert_array_equal(aligned, batch[0][0])
    np.testing.assert_array_equal(tform, batch[2][0])
    u8 = port.align_batch(frames[:1], lms[:1], out_uint8=True)[0]
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, np.clip(batch[0], 0, 255).astype(np.uint8))
    alms = port.get_aligned_landmarks(lms[0], tform)
    np.testing.assert_allclose(alms, jref.get_aligned_landmarks(lms[0], tform), atol=1e-4)
    assert port.compute_alignment_quality(alms) == pytest.approx(
        jref.compute_alignment_quality(alms), abs=1e-6)
    np.testing.assert_array_equal(port.reference, jref.reference)
    img = frames[0]
    norm = NormalizationProcessor().normalize(img)
    np.testing.assert_array_equal(norm, JNormalization().normalize(img))
    np.testing.assert_array_equal(NormalizationProcessor().denormalize(norm, to_uint8=True),
                                  JNormalization().denormalize(norm, to_uint8=True))
    with pytest.raises(ValueError, match="alignment method"):
        FaceAligner(method="projective", device="cpu")


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(720, 1280), (300, 200), (480, 640), (1080, 1920)])
def test_letterbox_matches_cv2(det_vars, hw):
    frame = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    jdet = JFaceDetector(params=det_vars, input_size=(640, 640))
    want, want_scale = jdet._prepare(frame)
    got, scale = letterbox(frame, (640, 640), "cpu")
    assert scale == want_scale and got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1
    if hw in ((480, 640), (1080, 1920)):  # no resize, or an exact factor of 3
        assert diff.max() == 0
    f32, _ = letterbox(frame.astype(np.float32), (640, 640), "cpu")
    assert f32.dtype == torch.float32


def _compare_detections(port, ref, atol):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert (p is None) == (r is None)
        if p is None:
            continue
        assert p["num_faces"] == r["num_faces"]
        np.testing.assert_allclose(p["bbox"], r["bbox"], atol=atol)
        np.testing.assert_allclose(p["landmarks"], r["landmarks"], atol=atol)
        assert abs(p["confidence"] - r["confidence"]) <= 1e-3


def test_detector_matches_jax(scenes, det_vars):
    frames, _ = scenes
    kw = dict(input_size=CANVAS, max_detections=16)
    jdet = JFaceDetector(params=det_vars, **kw)
    port = FaceDetector(device="cpu", **kw)  # the committed weights, as pretrained
    ref = jdet.batch_detect(list(frames))
    assert all(r is not None and r["confidence"] > 0.9 for r in ref)
    assert {r["num_faces"] for r in ref} != {1}, "some frames hold two faces"
    _compare_detections(port.batch_detect(list(frames)), ref, 1e-2)
    _compare_detections([port.detect(frames[0])], [jdet.detect(frames[0])], 1e-2)
    _compare_detections(port.batch_detect_device(torch.from_numpy(frames)), ref, 1e-2)
    # Frames of another size are letterboxed: within a pixel of the JAX decode.
    rng = np.random.default_rng(9)
    odd = [render_scene(rng, size=s, max_faces=1, p_empty=0.0, min_face=50, max_face=90)[0]
           for s in (200, 136)]
    _compare_detections(port.batch_detect(odd), jdet.batch_detect(odd), 1.0)
    # A blank frame holds no face.
    assert port.detect(np.full((*CANVAS, 3), 128, np.uint8)) is None
    bbox = np.asarray([10.5, 20.2, 60.7, 90.1], np.float32)
    np.testing.assert_array_equal(FaceDetector.get_face_roi(frames[0], bbox),
                                  JFaceDetector.get_face_roi(frames[0], bbox))
    with pytest.raises(ValueError, match="input_size"):
        port.batch_detect_device(torch.zeros((1, 32, 32, 3)))


def test_detector_factory_and_unported_families(det_vars):
    det = create_face_detector({"scrfd": {"input_size": [96, 96], "max_detections": 4},
                                "confidence_threshold": 0.3}, device="cpu")
    assert (det.input_size, det.max_detections, det.confidence_threshold) == ((96, 96), 4, 0.3)
    lite = create_face_detector({"model": "lite", "scrfd": {"input_size": [128, 128]}},
                                device="cpu")
    assert lite.model_name == "lite"
    # The families the port once lacked now construct (held to JAX in
    # tests/test_torch_detectors.py).
    mtcnn = create_face_detector({"model": "mtcnn", "scrfd": {"input_size": [128, 128]}},
                                 device="cpu")
    assert mtcnn.model_name == "mtcnn" and mtcnn.refiner is None
    for model in ("hog", "dlib"):
        hog = create_face_detector({"model": model, "scrfd": {"input_size": [96, 96]}},
                                   device="cpu")
        assert hog.model_name == "hog" and hog.input_size == (96, 96)
    assert create_face_detector({"refine": True, "scrfd": {"input_size": [96, 96]}},
                                device="cpu").refiner is not None
    with pytest.raises(ValueError, match="unknown detector"):
        create_face_detector({"model": "yolo"}, device="cpu")
    seeded = FaceDetector(input_size=(96, 96), pretrained=False, params=det_vars, device="cpu")
    ref = FaceDetector(input_size=(96, 96), device="cpu")
    for a, b in zip(seeded.model.state_dict().values(), ref.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Quality
# ---------------------------------------------------------------------------

def test_quality_checker_matches_jax(scenes):
    frames, lms = scenes
    rng = np.random.default_rng(2)
    images = np.concatenate([
        frames.astype(np.float32),
        np.full((1, *CANVAS, 3), 12.0, np.float32),                     # dark, no contrast
        np.clip(frames[:1] * 0.2 + 200.0, 0, 255).astype(np.float32),   # bright, flat
    ])
    lms_all = np.concatenate([lms, lms[:2]])
    bboxes = np.concatenate([rng.uniform(20, 40, (len(images), 2)),
                             rng.uniform(60, 150, (len(images), 2))], 1).astype(np.float32)
    bboxes[0, 2:] = bboxes[0, :2] + 20.0  # a face too small
    conf = rng.uniform(0.5, 1.0, len(images)).astype(np.float32)
    cfg = {"min_face_size": 40, "blur_threshold": 50.0}
    got = QualityChecker(cfg, device="cpu").check_quality_batch(images, lms_all, bboxes, conf)
    ref = JQualityChecker(cfg).check_quality_batch(images, lms_all, bboxes, conf)
    assert {r for g in got for r in g["reasons"]}, "some frames fail a check"
    for g, r in zip(got, ref):
        assert g["reasons"] == r["reasons"] and g["is_valid"] == r["is_valid"]
        assert g["overall_score"] == pytest.approx(r["overall_score"], abs=1e-4)
        assert set(g["scores"]) == set(r["scores"])
        for k in r["scores"]:
            assert g["scores"][k] == pytest.approx(r["scores"][k], rel=1e-3, abs=1e-3)
    info = {"bbox": bboxes[0], "confidence": float(conf[0])}
    single = QualityChecker(cfg, device="cpu").check_quality(images[0], lms_all[0], info)
    assert single["reasons"] == got[0]["reasons"]
    off = QualityChecker({"enabled": False}, device="cpu")
    assert off.check_quality(images[0], lms_all[0], info) == {
        "is_valid": True, "overall_score": 1.0, "scores": {}, "reasons": []}


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def _pipeline_config(**alignment):
    cfg = {**PREPROCESSING_CONFIG}
    cfg["detection"] = {**cfg["detection"], "scrfd": {"input_size": list(CANVAS),
                                                      "max_detections": 16}}
    cfg["alignment"] = {**cfg["alignment"], "output_size": [64, 64], **alignment}
    return cfg


@pytest.mark.parametrize("alignment", [{}, {"warp_window": 64}], ids=["whole-frame", "windowed"])
def test_pipeline_fused_matches_modular(scenes, alignment):
    frames, _ = scenes
    pipe = PreprocessingPipeline(_pipeline_config(**alignment), device="cpu")
    blank = np.full((*CANVAS, 3), 128, np.uint8)
    batch = list(frames) + [blank]
    fused = pipe.process_batch(batch, image_ids=[str(i) for i in range(len(batch))])
    # A frame of another size sends the batch through the modular stages.
    odd = render_scene(np.random.default_rng(4), size=96, max_faces=1, p_empty=0.0,
                       min_face=40, max_face=60)[0]
    modular = pipe.process_batch(batch + [odd])[:len(batch)]
    assert not fused[-1].success and fused[-1].failure_reason == "no_face_detected"
    for f, m in zip(fused, modular):
        assert f.success == m.success
        if not f.success:
            continue
        np.testing.assert_allclose(f.bbox, m.bbox, atol=1e-2)
        np.testing.assert_allclose(f.original_landmarks, m.original_landmarks, atol=1e-2)
        assert f.confidence == pytest.approx(m.confidence, abs=1e-4)
        assert f.quality_score == pytest.approx(m.quality_score, abs=1e-4)
        assert f.quality_details["reasons"] == m.quality_details["reasons"]
        assert np.abs(f.aligned_face.astype(int) - m.aligned_face.astype(int)).max() <= 1
        assert f.aligned_face.dtype == np.uint8 and f.aligned_face.shape == (64, 64, 3)
    stats = pipe.get_statistics()
    assert stats["total_processed"] == 2 * len(batch) + 1
    assert stats["failure_reasons"] == {"no_face_detected": 2}
    pipe.reset_statistics()
    assert pipe.get_statistics()["total_processed"] == 0


def test_pipeline_save_load_and_factory(scenes, tmp_path):
    frames, _ = scenes
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump(_pipeline_config()))
    pipe = create_pipeline_from_config(path, device="cpu")
    out = pipe.process_image(frames[0], image_id="7", dataset="synth", label="real")
    assert out.success and out.quality_details["overall_score"] == out.quality_score
    paths = pipe.save_output(out, tmp_path / "processed")
    assert set(paths) == {"face_path", "landmark_path", "metadata_path"}
    back = pipe.load_output(tmp_path / "processed", "synth_real_7")
    np.testing.assert_array_equal(back.aligned_face, out.aligned_face)
    np.testing.assert_array_equal(back.landmarks, out.landmarks)
    np.testing.assert_allclose(back.bbox, out.bbox)
    assert back.quality_details == out.quality_details and back.label == "real"
    model_in = back.to_model_input()
    assert model_in["image"].shape == (64, 64, 3) and model_in["image"].dtype == np.float32
    assert isinstance(PreprocessingOutput().quality_details, dict)
