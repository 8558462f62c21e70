"""Serving is unchanged by train mode: the port's networks now act on
``module.train()`` (batch statistics, dropout, drop-connect), so every
serving object runs them in eval mode. Each object's networks are in
eval mode once built; put back in train mode, the object gives the
outputs it gave before, bit for bit, and its networks are in eval mode
again. The existing parity tests of these objects run unchanged.
"""

import numpy as np
import pytest
import torch

from deepfake_vit_tpu.data.synth_faces import render_scene
from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.inference import DeepfakePredictor
from deepfake_vit_tpu_torch.preprocessing.detector import FaceDetector, default_weights_path

torch.set_num_threads(1)

COMMON = dict(detection_input_size=(128, 128), serving_size=(256, 256), output_size=(64, 64),
              warp_window=64, warp_fractional=True, confidence_threshold=0.0)
CFG = {"model": {"feature_extractor": {"variant": "b0"},
                 "classifier": {"hidden_dims": [16], "num_classes": 2}}}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return np.stack([render_scene(rng, size=256, max_faces=1, p_empty=0.0, min_face=60,
                                  max_face=140)[0] for _ in range(2)])


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), k
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=k)


@pytest.mark.parametrize("options", [{}, {"use_int8_tail": True, "int8_tail_start": 12},
                                     {"use_fused_backbone": True}])
def test_fused_pipeline_serves_in_eval_mode(frames, options):
    pipe = FusedPipeline(CFG, dtype=torch.float32, device="cpu", **COMMON, **options)
    pipe.load_variables(seed=0)
    assert not pipe.model.training and not pipe.detector.training
    want = pipe.forward(frames)
    pipe.model.train()
    pipe.detector.train()
    _same(pipe.forward(frames), want)
    assert not pipe.model.training and not pipe.detector.training


def test_predictor_and_detector_serve_in_eval_mode(frames):
    pre = {**PREPROCESSING_CONFIG,
           "detection": {**PREPROCESSING_CONFIG["detection"],
                         "scrfd": {"input_size": [192, 192], "max_detections": 16}}}
    pred = DeepfakePredictor.from_packaged(default_weights_path("classifier"), pre,
                                           dtype=torch.float32, device="cpu", max_batch=4)
    assert not pred.model.training and not pred.detector.model.training
    want = pred.predict_frames(list(frames))
    assert want["num_faces"] == 2
    pred.model.train()
    pred.detector.model.train()
    assert pred.predict_frames(list(frames)) == want
    assert not pred.model.training and not pred.detector.model.training

    det = FaceDetector(input_size=(128, 128), device="cpu")
    want = det.batch_detect(list(frames))
    assert all(w is not None for w in want)
    det.model.train()
    for got, ref in zip(det.batch_detect(list(frames)), want):
        _same(got, ref)
    assert not det.model.training
