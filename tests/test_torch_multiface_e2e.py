"""The port's FusedPipeline vs the JAX FusedPipeline with the tap modes, the
lite detector and multi-face serving: serving 256², detection 128², 64²
faces, the committed EfficientNet-b0 classifier, float32, on three
rendered scenes with two faces each.

- ``int8``: SCRFD, the fractional window 64 with the rank-1 "mxu" crop and
  the int8 warp, one face per frame;
- ``uw16_lite_k3``: the lite detector, the pooled window 64 with the uw16
  warp, ``keep_top_k=3`` (outputs (B, 3, …) and ``face_valid``): each
  frame's two faces survive the NMS of the top 32 anchors and the third
  slot is empty (index −1, not valid), as the JAX graph gives it.

The JAX side runs its Pallas windowed warp in interpret mode (patched as
tests/test_torch_e2e.py does); the port runs its kernels' plain versions.
``has_face``/``face_valid`` identical; ``bbox``/``landmarks`` within 1e-2
px; ``quality`` within 1e-2; ``fake_prob`` within 0.02 for uw16 and 0.03
for int8, whose q7 taps may land a step apart where XLA's CPU compiler
contracts the warp coordinates into FMAs (tests/test_torch_tap_modes.py).
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
from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path

torch.set_num_threads(1)

CLASSIFIER = "deepfake_vit_tpu/weights/classifier_synface.msgpack"
CFG = {"model": {"feature_extractor": {"variant": "b0", "dropout_rate": 0.0},
                 "classifier": {"hidden_dims": [512, 128, 32], "num_classes": 2}}}
COMMON = dict(detection_input_size=(128, 128), serving_size=(256, 256), output_size=(64, 64),
              warp_window=64, confidence_threshold=0.5)
CASES = {
    "int8": (dict(warp_fractional=True, warp_tap_mode="int8"), 0.03),
    "uw16_lite_k3": (dict(warp_fractional=False, warp_tap_mode="uw16", detector_arch="lite",
                          keep_top_k=3), 0.02),
}


def _restore(path):
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(8)
    scenes = [render_scene(rng, size=256, max_faces=3, p_empty=0.0, min_face=40, max_face=100)
              for _ in range(3)]
    assert [len(s[1]) for s in scenes] == [2, 2, 2]
    return np.stack([s[0] for s in scenes])


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_pipeline_matches_jax(frames, monkeypatch, case):
    options, prob_tol = CASES[case]
    ck = _restore(CLASSIFIER)
    model_vars = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    det_vars = _restore(default_weights_path(options.get("detector_arch", "scrfd")))

    jpipe = je2e.FusedPipeline(CFG, dtype=jnp.float32, **COMMON, **options)
    monkeypatch.setattr(je2e, "warp_affine_windowed", partial(warp_affine_windowed, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.device_get(jax.jit(jpipe._graph)(det_vars, model_vars, jnp.asarray(frames)))

    pipe = FusedPipeline(CFG, dtype=torch.float32, device="cpu", **COMMON, **options)
    pipe.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}

    assert set(out) == set(ref)
    for k in out:
        assert out[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    K = options.get("keep_top_k", 1)
    if K > 1:
        assert out["bbox"].shape == (3, K, 4)
        np.testing.assert_array_equal(out["face_valid"], ref["face_valid"])
        np.testing.assert_array_equal(out["face_valid"].sum(1), [2, 2, 2])
    else:
        assert out["has_face"].all()
    np.testing.assert_allclose(out["confidence"], ref["confidence"], atol=1e-4)
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=1e-2)
    np.testing.assert_allclose(out["landmarks"], ref["landmarks"], atol=1e-2)
    np.testing.assert_allclose(out["quality"], ref["quality"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=prob_tol)
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, rtol=1e-5)
