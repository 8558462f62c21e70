"""The port's networks vs the JAX package's, weights carried across by
``models/bridge.py``, in float32 on the CPU.

Trained weights keep activations at their real magnitudes: the committed
SCRFD detector at full width, and the committed EfficientNet-b0
classifier (backbone, hybrid attention, [512, 128, 32] head). Float32
convolutions sum in a different order in XLA and in PyTorch; through a
dozen to a few dozen layers that leaves ~1e-5 relative error, so the
tolerances are 1e-3 relative to each output's scale.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_vit_tpu.models.attention import HybridAttention as JHybrid
from deepfake_vit_tpu.models.efficientnet import EfficientNetBackbone as JBackbone
from deepfake_vit_tpu.models.feature_extractor import create_model_from_config as jcreate
from deepfake_vit_tpu.models.scrfd import ScrfdDetector as JScrfd
from deepfake_vit_tpu.models.scrfd import fold_stem_pool_params as jfold
from deepfake_vit_tpu_torch.models.attention import HybridAttention
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables
from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone, block_args
from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
from deepfake_vit_tpu_torch.models.scrfd import ScrfdDetector, fold_stem_pool_params
from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path

torch.set_num_threads(1)

CLASSIFIER = "deepfake_vit_tpu/weights/classifier_synface.msgpack"


def _restore(path):
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


def _close(port, ref, rel=1e-3):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(port - ref).max() / scale
    assert err <= rel, f"max error {err:.2e} of scale {scale:.3g}"


@pytest.fixture(scope="module")
def det_vars():
    return _restore(default_weights_path("scrfd"))


@pytest.fixture(scope="module")
def clf_vars():
    ck = _restore(CLASSIFIER)
    return {"params": ck["params"], "batch_stats": ck["batch_stats"]}, ck["model_config"]


@pytest.mark.parametrize("pool", [1, 2])
def test_scrfd_matches(det_vars, pool):
    """Full-width SCRFD on a 64² canvas; pool=2 feeds 128² frames to the
    folded stem (k6-s4, (0, 2) padding) — fold_stem_pool_params."""
    x = np.random.default_rng(0).normal(0, 0.6, (2, 64 * pool, 64 * pool, 3)).astype(np.float32)
    jv = jfold(det_vars, pool)
    ref = jax.jit(lambda v, a: JScrfd(stem_pool=pool).apply(v, a, train=False))(jv, jnp.asarray(x))
    port = load_flax_variables(ScrfdDetector(stem_pool=pool), det_vars).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert sorted(out) == sorted(ref) == [8, 16, 32]
    for s in ref:
        for k in ("scores", "bbox", "kps"):
            assert out[s][k].shape == ref[s][k].shape, (s, k)
            _close(out[s][k].numpy(), ref[s][k])


def test_fold_stem_pool_params_matches(det_vars):
    folded_j = jfold(det_vars, 2)["params"]["_ConvBN_0"]["Conv_0"]["kernel"]
    folded_t = fold_stem_pool_params(det_vars, 2)["params"]["_ConvBN_0"]["Conv_0"]["kernel"]
    assert folded_t.shape == (6, 6, 3, 32)
    np.testing.assert_array_equal(np.asarray(folded_t), np.asarray(folded_j))
    assert fold_stem_pool_params(det_vars, 1) is det_vars


def test_efficientnet_b0_backbone_matches(clf_vars):
    variables, _ = clf_vars
    sub = {c: variables[c]["feature_extractor"]["backbone"] for c in variables}
    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda v, a: JBackbone(variant="b0").apply(v, a, train=False, return_maps=True))(
        sub, jnp.asarray(x))
    port = load_flax_variables(EfficientNetBackbone("b0"), sub).eval()
    assert len(block_args("b0")) == 16
    with torch.no_grad():
        maps = port(torch.from_numpy(x))
    _close(maps.permute(0, 2, 3, 1).numpy(), ref)  # NCHW → NHWC


def test_hybrid_attention_matches(clf_vars):
    """Landmark (fixed 224 input frame, global max), channel and spatial."""
    variables, _ = clf_vars
    sub = {"params": variables["params"]["feature_extractor"]["attention"]}
    rng = np.random.default_rng(2)
    maps = rng.normal(0, 1, (3, 6, 6, 1280)).astype(np.float32)
    lms = rng.uniform(0, 192, (3, 5, 2)).astype(np.float32)
    ref = JHybrid(channels=1280, feature_size=(6, 6)).apply(sub, jnp.asarray(maps), jnp.asarray(lms))
    port = load_flax_variables(HybridAttention(1280), sub)
    with torch.no_grad():
        out = port(torch.from_numpy(maps).permute(0, 3, 1, 2), torch.from_numpy(lms))
    _close(out.permute(0, 2, 3, 1).numpy(), ref, rel=1e-5)


def test_detection_model_with_head_matches(clf_vars):
    """Whole classifier: backbone → attention → pool → [512, 128, 32] head."""
    variables, cfg = clf_vars
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    lms = rng.uniform(10, 54, (2, 5, 2)).astype(np.float32)
    jm = jcreate(cfg)
    logits_j, feats_j = jax.jit(lambda v, a, l: jm.apply(v, a, l, train=False, return_features=True))(
        variables, jnp.asarray(x), jnp.asarray(lms))
    port = load_flax_variables(create_model_from_config(cfg), variables).eval()
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(x), torch.from_numpy(lms))
    assert logits.dtype == feats.dtype == torch.float32
    _close(feats.numpy(), feats_j)
    _close(logits.numpy(), logits_j)


def test_bridge_is_strict(det_vars):
    port = ScrfdDetector()
    params = dict(det_vars["params"])
    params.pop("lat5")
    with pytest.raises(KeyError, match="not set"):
        load_flax_variables(port, {"params": params, "batch_stats": det_vars["batch_stats"]})
    params = dict(det_vars["params"], extra={"kernel": np.zeros((1, 1, 1, 1))})
    with pytest.raises(KeyError, match="extra"):
        load_flax_variables(port, {"params": params, "batch_stats": det_vars["batch_stats"]})
    bad = dict(det_vars["params"], lat5={"kernel": np.zeros((1, 1, 256, 32)), "bias": np.zeros(32)})
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(port, {"params": bad, "batch_stats": det_vars["batch_stats"]})
