"""The port's space-to-depth early stages (``models/s2d_early.py``) vs the
JAX package's, on the CPU.

- ``_phase_taps``, the tap algebra of XLA's SAME padding that decides which
  pixels each phase reads: **equal** to the JAX function for the stem
  (k3 s2, blocks 4 → 2), the stride-1 depthwise (k3 s1, 2 → 2) and the
  stride-2 depthwise (k3 and k5 s2, 2 → 1) at h = 48, 96 and 112.
- ``S2DEarlyRunner`` against the JAX ``S2DEarlyRunner`` on the same
  weights (numpy-seeded BatchNorm statistics) and inputs: b0 at 96², and
  B4's widths at 96² and 192² (192² is the served face size: h = 96,
  h_out = 48), B = 2, within the JAX test's own ``atol=0.05, rtol=0.05``
  (``tests/test_s2d_early.py``): both round to bf16 at the same points and
  sum in other orders. Also against the port's stock blocks within the
  same bound, and resuming the stock backbone from ``resume_block``.
- ``FusedPipeline(use_s2d_early=True)`` alone and with ``use_int8_tail``
  against the JAX pipeline with the same flags at ``tests/test_torch_e2e.py``'s
  small configuration (trained b0 classifier, 64² faces, dynamic int8
  scales), ``fake_prob`` within 0.02 as there, ``has_face`` identical.
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
from deepfake_vit_tpu.models.s2d_early import S2DEarlyRunner as JRunner
from deepfake_vit_tpu.models.s2d_early import _phase_taps as j_phase_taps
from deepfake_vit_tpu.ops.warp import warp_affine_windowed
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
from deepfake_vit_tpu_torch.models.layers import BatchNorm, Conv, init_weights
from deepfake_vit_tpu_torch.models.s2d_early import S2DEarlyRunner, _phase_taps
from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path

torch.set_num_threads(1)

CLASSIFIER = "deepfake_vit_tpu/weights/classifier_synface.msgpack"
COMMON = dict(detection_input_size=(128, 128), serving_size=(256, 256), output_size=(64, 64),
              warp_window=64, warp_fractional=True, confidence_threshold=0.0)
TAPS = {"stem k3 s2": (3, 2, 4, 2), "dw k3 s1": (3, 1, 2, 2), "dw k3 s2": (3, 2, 2, 1),
        "dw k5 s2": (5, 2, 2, 1)}


@pytest.mark.parametrize("h", [48, 96, 112])
@pytest.mark.parametrize("kind", list(TAPS))
def test_phase_taps_match_jax(kind, h):
    assert _phase_taps(*TAPS[kind], h) == j_phase_taps(*TAPS[kind], h)


def _seeded_backbone(variant, seed):
    """The port's backbone with seeded flax-default weights and BatchNorm
    statistics away from the identity (mean N(0, 0.2), var in [0.5, 1.1)),
    so that the folding counts."""
    backbone = init_weights(EfficientNetBackbone(variant, dtype=torch.bfloat16), seed).eval()
    rng = np.random.default_rng(seed)
    for m in backbone.modules():
        if isinstance(m, BatchNorm):
            n = m.running_mean.numel()
            m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                np.abs(rng.normal(0, 0.2, n)).astype(np.float32) + 0.5))
    return backbone


def _flax_tree(module):
    """(params, batch_stats) of a port module in the flax layout: the
    inverse of each layer's ``load_flax``."""
    if isinstance(module, Conv):
        p = {"kernel": module.weight.detach().permute(2, 3, 1, 0).numpy()}
        if module.bias is not None:
            p["bias"] = module.bias.detach().numpy()
        return p, {}
    if isinstance(module, BatchNorm):
        return ({"scale": module.weight.detach().numpy(), "bias": module.bias.detach().numpy()},
                {"mean": module.running_mean.numpy(), "var": module.running_var.numpy()})
    params, stats = {}, {}
    for name, child in module.named_children():
        params[name], st = _flax_tree(child)
        if st:
            stats[name] = st
    return params, stats


@pytest.mark.parametrize("variant,size", [("b0", 96), ("b4", 96), ("b4", 192)])
def test_runner_matches_jax(variant, size):
    backbone = _seeded_backbone(variant, seed=7)
    runner = S2DEarlyRunner(backbone, image_size=size)
    assert runner.resume_block == (2 if variant == "b0" else 3)
    # The JAX runner reads the stem and the blocks it replaces, nothing else.
    params, stats = {}, {}
    for name in ["stem_conv", "stem_bn"] + [f"block_{i}" for i in range(runner.resume_block)]:
        params[name], st = _flax_tree(getattr(backbone, name))
        if st:
            stats[name] = st
    x = np.random.default_rng(0).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    ref = jax.device_get(jax.jit(
        lambda p, s, a: JRunner(variant, p, s, image_size=size)(a))(params, stats, jnp.asarray(x)))
    ref = np.asarray(ref, np.float32)

    out = runner(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    got = out.permute(0, 2, 3, 1).float().numpy()
    cout = backbone.blocks[runner.resume_block]["in_filters"]
    assert got.shape == ref.shape == (2, size // 4, size // 4, cout)
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0.05)

    # The stock blocks give the same activation, and the stock backbone
    # resumes from it.
    with torch.inference_mode():
        stock = backbone(torch.from_numpy(x), stop_block=runner.resume_block)
        np.testing.assert_allclose(got, stock.permute(0, 2, 3, 1).float().numpy(),
                                   atol=0.05, rtol=0.05)
        resumed = backbone(out, start_block=runner.resume_block).float()
        full = backbone(torch.from_numpy(x)).float()
    assert torch.isfinite(resumed).all() and resumed.shape == full.shape


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return np.stack([render_scene(rng, size=256, max_faces=1, p_empty=0.0, min_face=60,
                                  max_face=140)[0] for _ in range(4)])


@pytest.mark.parametrize("int8_tail", [False, True], ids=["s2d", "s2d+int8_tail"])
def test_pipeline_matches_jax(frames, monkeypatch, int8_tail):
    with open(default_weights_path("scrfd"), "rb") as f:
        det_vars = flax.serialization.msgpack_restore(f.read())
    with open(CLASSIFIER, "rb") as f:
        ck = flax.serialization.msgpack_restore(f.read())
    model_vars = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    cfg = {"model": {"feature_extractor": {"variant": "b0", "dropout_rate": 0.0},
                     "classifier": {"hidden_dims": [512, 128, 32], "num_classes": 2}}}
    flags = dict(use_s2d_early=True, use_int8_tail=int8_tail)

    jpipe = je2e.FusedPipeline(cfg, dtype=jnp.float32, **flags, **COMMON)
    monkeypatch.setattr(je2e, "warp_affine_windowed",
                        partial(warp_affine_windowed, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        # bf16 stages: compiled without excess precision, so that XLA's CPU
        # compiler rounds where the graph casts, as the TPU and the port do.
        args = (det_vars, model_vars, jnp.asarray(frames))
        ref = jax.device_get(jax.jit(jpipe._graph).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args))

    pipe = FusedPipeline(cfg, dtype=torch.float32, device="cpu", **flags, **COMMON)
    pipe.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    assert pipe._s2d.resume_block == 2 and (pipe._tail is not None) == int8_tail
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}

    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    assert ref["confidence"].min() > 0.9, "rendered faces give a clear best face"
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=1e-2)
    np.testing.assert_allclose(out["quality"], ref["quality"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=0.02)
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, rtol=1e-5)
