"""The port's MTCNN-Lite, HOG and cascade-refiner detectors and the
MTCNN-Lite serving pipeline against the JAX package, on the CPU, in
float32 with the committed weights.

- MTCNN-Lite on the 24 held-out 160² scenes of
  ``tests/test_detector_trained.py::test_mtcnn_lite_trained_quality``: the
  same valid detections, boxes and landmarks within 1e-3 px, scores within
  1e-5.
- HOG: ``pyramid_sizes`` equal; the cells within 1e-4 of the largest cell
  (a pixel whose ``arctan2`` lands an ulp across a bin edge moves its vote
  to the neighbouring bin's share continuously, so no cell jumps: 0
  positions over 1e-4 on these scenes), blocks and descriptors within
  1e-6; the resize of each pyramid level within 5.1e-5 + 1e-6·max of a
  float64 resize with ``jax.image.resize``'s own weights (JAX's CPU result
  is 2.5e-3 from it); ``HogFaceDetector`` with ``hog_synface.msgpack`` on
  320² scenes: the same detections, scores within 1e-5, boxes within
  1e-3 px.
- The cascade: ``refine_detections`` with the committed refiner on a
  hand-made slate, and ``FaceDetector(refine=True)`` on 320² scenes: the
  same valid slots, boxes and landmarks within 1e-3 px, scores within
  1e-5.
- ``FusedPipeline(detector_arch="mtcnn")``, b0 at 64² faces from 160²
  frames (the pooled window 64, legacy taps): the tolerances of
  ``tests/test_torch_multiface_e2e.py`` (bbox and landmarks 1e-2 px,
  quality 1e-2, fake_prob 0.02). At a serving/detection ratio of 2 the
  port raises a ``ValueError``.
"""

from functools import partial

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale
from jax.experimental.pallas import tpu as pltpu

import deepfake_vit_tpu.e2e as je2e
from deepfake_vit_tpu.data.synth_faces import render_scene
from deepfake_vit_tpu.models import hog_detector as jh
from deepfake_vit_tpu.models import refine_net as jr
from deepfake_vit_tpu.ops.warp import warp_affine_windowed
from deepfake_vit_tpu.preprocessing import detector as jd
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables
from deepfake_vit_tpu_torch.models.layers import init_weights
from deepfake_vit_tpu_torch.models import hog_detector as th
from deepfake_vit_tpu_torch.models import refine_net as tr
from deepfake_vit_tpu_torch.preprocessing import detector as td

torch.set_num_threads(1)
HELDOUT_SEED = 20260816  # tests/test_detector_trained.py's
CLASSIFIER = "deepfake_vit_tpu/weights/classifier_synface.msgpack"


def _scenes(seed, n, size, min_face, max_face):
    rng = np.random.default_rng(seed)
    frames = []
    while len(frames) < n:
        img, boxes, _ = render_scene(rng, size=size, max_faces=1, min_face=min_face,
                                     max_face=max_face, p_empty=0.0)
        if len(boxes):
            frames.append(img)
    return np.stack(frames)


def _assert_same_dets(got, want, score_tol=1e-5, px=1e-3):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.any()
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=0, atol=score_tol)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=px)
    np.testing.assert_allclose(got["landmarks"][v], want["landmarks"][v], rtol=0, atol=px)


def test_mtcnn_lite_matches_jax():
    frames = _scenes(HELDOUT_SEED + 7, 24, 160, 36, 110).astype(np.float32)
    kw = dict(model_name="mtcnn", confidence_threshold=0.3, input_size=(160, 160))
    want = jax.device_get(jd.FaceDetector(**kw).detect_batch_raw(frames))
    det = td.create_face_detector({"model": "mtcnn", "confidence_threshold": 0.3,
                                   "scrfd": {"input_size": [160, 160]}}, device="cpu")
    assert isinstance(det.model, td.MtcnnLiteDetector)
    _assert_same_dets(det.detect_batch_raw(frames), want)
    assert want["valid"].any(axis=1).sum() >= 20


@pytest.fixture(scope="module")
def hog_frames():
    return _scenes(HELDOUT_SEED, 6, 320, 48, 180)


def _gray(frames):
    return frames.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)


def test_hog_features_match_jax(hog_frames):
    assert th.pyramid_sizes((320, 320), 1) == jh.pyramid_sizes((320, 320), 1)
    assert th.pyramid_sizes((200, 152), 0) == jh.pyramid_sizes((200, 152), 0)
    gray = _gray(hog_frames)
    cells_j = np.asarray(jax.device_get(jax.jit(jh.hog_cells)(jnp.asarray(gray))))
    cells_t = th.hog_cells(torch.from_numpy(gray)).numpy()
    gap = np.abs(cells_t - cells_j)
    assert int((gap > 1e-4 * cells_j.max()).sum()) == 0
    blocks_j = np.asarray(jax.device_get(jax.jit(jh.hog_blocks)(jnp.asarray(cells_j))))
    np.testing.assert_allclose(th.hog_blocks(torch.from_numpy(cells_j.copy())).numpy(), blocks_j,
                               rtol=0, atol=1e-6)
    wins = gray[:, 40:120, 100:180]
    desc_j = np.asarray(jax.device_get(jax.jit(jh.hog_descriptor)(jnp.asarray(wins))))
    desc_t = th.hog_descriptor(torch.from_numpy(np.ascontiguousarray(wins))).numpy()
    assert desc_t.shape == (6, 2916)
    np.testing.assert_allclose(desc_t, desc_j, rtol=0, atol=1e-6)


def _jax_resize_weights(n_in, n_out):
    linear = jax_scale._kernels[jax.image.ResizeMethod.LINEAR]
    return np.asarray(jax_scale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, linear, True),
                      np.float64)


def test_hog_pyramid_resize(hog_frames):
    gray = _gray(hog_frames[:2])
    for h, w in th.pyramid_sizes((320, 320), 1):
        exact = (_jax_resize_weights(320, h).T @ gray.astype(np.float64)
                 @ _jax_resize_weights(320, w))
        got = th.resize_linear(torch.from_numpy(gray), (h, w)).numpy()
        np.testing.assert_allclose(got, exact, rtol=0, atol=5.1e-5 + 1e-6 * np.abs(exact).max())


@pytest.mark.parametrize("model", ["hog", "dlib"])
def test_hog_detector_matches_jax(hog_frames, model):
    cfg = {"model": model, "scrfd": {"input_size": [320, 320]}}
    want = jax.device_get(jd.create_face_detector(cfg).detect_batch_raw(hog_frames))
    det = td.create_face_detector(cfg, device="cpu")
    assert isinstance(det, th.HogFaceDetector)
    _assert_same_dets(det.detect_batch_raw(hog_frames), want)
    found = det.batch_detect(list(hog_frames))
    assert sum(r is not None for r in found) >= 5


def test_hog_weights_round_trip(tmp_path):
    det = th.HogFaceDetector(input_size=(160, 160), device="cpu")
    path = tmp_path / "hog.msgpack"
    det.save_weights(str(path))
    back = jh.HogFaceDetector(input_size=(160, 160), pretrained=False)
    back.load_weights(str(path))
    np.testing.assert_array_equal(np.asarray(back.variables["template"]), det.params["template"])
    np.testing.assert_array_equal(np.asarray(back.variables["bias"]), det.params["bias"])


def _restore(path):
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


def test_refine_detections_matches_jax():
    rng = np.random.default_rng(4)
    B, D, K = 2, 6, 3
    images = rng.normal(0, 1, (B, 96, 96, 3)).astype(np.float32)
    xy = rng.uniform(-10, 70, (B, D, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(12, 50, (B, D, 2))], -1).astype(np.float32)
    dets = {"boxes": boxes, "scores": rng.uniform(0.3, 1, (B, D)).astype(np.float32),
            "landmarks": rng.uniform(0, 96, (B, D, 5, 2)).astype(np.float32),
            "valid": rng.uniform(size=(B, D)) < 0.8}
    variables = _restore(td.default_weights_path("refine"))
    ref = jax.device_get(jr.refine_detections(jr.RefineNet().apply, variables,
                                              jnp.asarray(images), dets, top_k=K,
                                              refine_threshold=0.4))
    net = init_weights(tr.RefineNet(), 0).eval()
    load_flax_variables(net, variables)
    got = tr.refine_detections(net, torch.from_numpy(images),
                               {k: torch.from_numpy(v) for k, v in dets.items()}, top_k=K,
                               refine_threshold=0.4)
    got = {k: v.detach().numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["landmarks"], ref["landmarks"], rtol=0, atol=1e-3)
    crops_j = jax.device_get(jax.vmap(lambda im, b: jr.crop_and_resize(
        jnp.broadcast_to(im[None], (K, *im.shape)), b, (64, 64)))(
        jnp.asarray(images), jr.square_boxes(jnp.asarray(boxes[:, :K]))))
    crops_t = tr.refine_crops(torch.from_numpy(images),
                              tr.square_boxes(torch.from_numpy(boxes[:, :K])))
    np.testing.assert_allclose(crops_t.numpy(), np.asarray(crops_j).reshape(B * K, 64, 64, 3),
                               rtol=0, atol=1e-5)


def test_cascade_detector_matches_jax():
    frames = _scenes(HELDOUT_SEED + 21, 6, 320, 48, 220).astype(np.float32)
    kw = dict(confidence_threshold=0.3, input_size=(320, 320), refine=True, refine_threshold=0.5)
    want = jax.device_get(jd.FaceDetector(**kw).detect_batch_raw(frames))
    det = td.FaceDetector(**kw, device="cpu")
    assert det.refiner is not None
    _assert_same_dets(det.detect_batch_raw(frames), want)
    with pytest.raises(ValueError, match="refine=True"):
        td.FaceDetector(input_size=(64, 64), device="cpu").load_refiner_weights(
            td.default_weights_path("refine"))


CFG = {"model": {"feature_extractor": {"variant": "b0", "dropout_rate": 0.0},
                 "classifier": {"hidden_dims": [512, 128, 32], "num_classes": 2}}}
COMMON = dict(detection_input_size=(160, 160), serving_size=(160, 160), output_size=(64, 64),
              warp_window=64, confidence_threshold=0.3, detector_arch="mtcnn")


def test_mtcnn_pipeline_matches_jax(monkeypatch):
    frames = _scenes(HELDOUT_SEED + 7, 3, 160, 36, 110)
    ck = _restore(CLASSIFIER)
    model_vars = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    det_vars = _restore(td.default_weights_path("mtcnn"))
    jpipe = je2e.FusedPipeline(CFG, dtype=jnp.float32, **COMMON)
    monkeypatch.setattr(je2e, "warp_affine_windowed", partial(warp_affine_windowed, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.device_get(jax.jit(jpipe._graph)(det_vars, model_vars, jnp.asarray(frames)))

    pipe = FusedPipeline(CFG, dtype=torch.float32, device="cpu", **COMMON)
    pipe.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    assert out["has_face"].all()
    np.testing.assert_allclose(out["confidence"], ref["confidence"], atol=1e-4)
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=1e-2)
    np.testing.assert_allclose(out["landmarks"], ref["landmarks"], atol=1e-2)
    np.testing.assert_allclose(out["quality"], ref["quality"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=0.02)

    with pytest.raises(ValueError, match="mtcnn"):
        FusedPipeline(CFG, dtype=torch.float32, device="cpu",
                      **{**COMMON, "serving_size": (320, 320)})
