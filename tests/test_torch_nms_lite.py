"""The port's fixed-size NMS and S2D-Lite detector vs the JAX package's.

NMS: float32 boxes, the same greedy steps; indices and ``valid`` must be
identical, tied scores included (both frameworks' argmax keeps the lower
index) and with fewer survivors than ``max_outputs`` (padded with −1).

LiteDetector: the committed ``lite_synface.msgpack`` carried across by
``models/bridge.py``, float32 on a 64² canvas; ``stem_pool=2`` feeds 128²
frames to the folded stem. Float32 convolutions sum in another order in
XLA and in PyTorch, so outputs agree within 1e-3 of each output's scale
(as tests/test_torch_models.py holds the SCRFD detector); the folded
kernel itself is equal bit for bit.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_vit_tpu.models.lite_detector import LiteDetector as JLite
from deepfake_vit_tpu.models.lite_detector import fold_stem_pool_params_lite as jfold
from deepfake_vit_tpu.models.lite_detector import space_to_depth as jspace_to_depth
from deepfake_vit_tpu.ops.nms import iou_matrix as j_iou_matrix
from deepfake_vit_tpu.ops.nms import nms_batched as j_nms_batched
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables
from deepfake_vit_tpu_torch.models.lite_detector import (LiteDetector, fold_stem_pool_params_lite,
                                                         space_to_depth)
from deepfake_vit_tpu_torch.ops import nms as tnms
from deepfake_vit_tpu_torch.preprocessing.detector import build_detection_net, default_weights_path

torch.set_num_threads(1)


def _boxes(rng, B, N, extent=100.0):
    xy = rng.uniform(0, extent, (B, N, 2))
    wh = rng.uniform(4, 40, (B, N, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "ties", "few_survivors"])
def test_nms_batched_matches_jax(case):
    rng = np.random.default_rng({"random": 0, "ties": 1, "few_survivors": 2}[case])
    B, N, K = 4, 48, 6
    boxes = _boxes(rng, B, N)
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4) / 4  # five score levels: many exact ties
        boxes[:, 1::2] = boxes[:, 0::2] + 0.5  # pairs of near-duplicates
    if case == "few_survivors":
        scores[:, 3:] = 0.0  # at most three live candidates per row
        boxes[1] = boxes[1, :1]  # row 1: one box repeated, one survivor
    ref_i, ref_v = jax.device_get(j_nms_batched(jnp.asarray(boxes), jnp.asarray(scores),
                                                   iou_threshold=0.4, max_outputs=K))
    idx, ok = tnms.nms_batched(torch.from_numpy(boxes), torch.from_numpy(scores),
                               iou_threshold=0.4, max_outputs=K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_v))
    if case == "few_survivors":
        assert (idx.numpy()[:, 3:] == -1).all() and ok.numpy()[1].sum() == 1
    if case == "ties":
        assert ok.numpy().all()
    one_i, one_v = tnms.nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                            iou_threshold=0.4, max_outputs=K)
    np.testing.assert_array_equal(one_i.numpy(), np.asarray(ref_i)[0])
    np.testing.assert_array_equal(one_v.numpy(), np.asarray(ref_v)[0])


def test_iou_matrix_matches_jax():
    rng = np.random.default_rng(3)
    a, b = _boxes(rng, 1, 7)[0], _boxes(rng, 1, 9)[0]
    a[0] = [5.0, 5.0, 5.0, 9.0]  # zero area
    ref = np.asarray(j_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tnms.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               ref, rtol=1e-6, atol=1e-7)


def _restore(path):
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def lite_vars():
    return _restore(default_weights_path("lite"))


def _close(port, ref, rel=1e-3):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(port - ref).max() / scale
    assert err <= rel, f"max error {err:.2e} of scale {scale:.3g}"


@pytest.mark.parametrize("pool", [1, 2])
def test_lite_detector_matches_jax(lite_vars, pool):
    x = np.random.default_rng(0).normal(0, 0.6, (2, 64 * pool, 64 * pool, 3)).astype(np.float32)
    ref = jax.device_get(jax.jit(lambda v, a: JLite(stem_pool=pool).apply(v, a, train=False))(
        jfold(lite_vars, pool), jnp.asarray(x)))
    port = load_flax_variables(build_detection_net("lite", stem_pool=pool), lite_vars).eval()
    assert isinstance(port, LiteDetector)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert sorted(out) == sorted(ref) == [8, 16, 32]
    for s in ref:
        for k in ("scores", "bbox", "kps"):
            assert out[s][k].shape == ref[s][k].shape, (s, k)
            _close(out[s][k].numpy(), ref[s][k])


def test_lite_fold_and_space_to_depth_match_jax(lite_vars):
    folded_j = jfold(lite_vars, 2)["params"]["conv1"]["Conv_0"]["kernel"]
    folded_t = fold_stem_pool_params_lite(lite_vars, 2)["params"]["conv1"]["Conv_0"]["kernel"]
    assert folded_t.shape == (3, 3, 192, 64)
    np.testing.assert_array_equal(np.asarray(folded_t), np.asarray(folded_j))
    assert fold_stem_pool_params_lite(lite_vars, 1) is lite_vars
    x = np.random.default_rng(1).normal(size=(2, 16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jspace_to_depth(jnp.asarray(x), 4)))
