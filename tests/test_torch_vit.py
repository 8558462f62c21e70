"""The port's ViT family against the JAX package's, on ``tiny16`` (width
192, 12 blocks, 3 heads) with the same weights, on the CPU.

- Float32 at 64² and 32² faces: logits and CLS features within ``atol
  2e-4, rtol 1e-3`` (the bound ``tests/test_vit.py`` pins for the JAX
  model against HuggingFace's), and ``predict`` is the softmax.
- bf16 at 64², the JAX model compiled with
  ``xla_allow_excess_precision=False`` (XLA's CPU compiler otherwise keeps
  bf16 intermediates in float32): the probabilities within 0.03 (the
  seeded head's logits are of the order of 1, so the probabilities spread
  over (0, 1); the test asserts a spread of at least 0.3).
- ``convert_hf_vit``: the port's tree equals the JAX function's
  (``np.array_equal`` leaf by leaf) on one synthetic HuggingFace-layout
  state dict (of torch tensors, as HuggingFace's ``state_dict`` gives),
  and ``load_hf_vit`` loads it.
- The bridge: the port exports the tree it loaded, the same leaves and
  values; loading stays strict for the module-level ``cls_token`` and
  ``pos_embed``.
- One AdamW step with clipping (dropout 0) against JAX ``make_train_step``
  with ``batch_stats={}``: loss and grad_norm within 1e-4 relative, the
  parameters within 1e-4 of their leaf's scale (at least 1), the
  analytically zero-gradient leaves (the key projection's bias: a
  constant added to every key's score leaves the softmax unchanged)
  within 2 lr, as in ``tests/test_torch_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_vit_tpu.models.vit import ViTClassifier as JViT
from deepfake_vit_tpu.models.vit import convert_hf_vit as j_convert_hf_vit
from deepfake_vit_tpu.training import create_optimizer as jcreate_optimizer
from deepfake_vit_tpu.training import make_criterion as jmake_criterion
from deepfake_vit_tpu.training.train_state import TrainState as JState
from deepfake_vit_tpu.training.train_state import make_train_step as jmake_train_step
from deepfake_vit_tpu_torch.models.bridge import export_flax_variables, load_flax_variables
from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
from deepfake_vit_tpu_torch.models.layers import init_weights
from deepfake_vit_tpu_torch.models.vit import VIT_CONFIGS, ViTClassifier, convert_hf_vit
from deepfake_vit_tpu_torch.models.vit import load_hf_vit
from deepfake_vit_tpu_torch.training import TrainState, create_optimizer, make_criterion
from deepfake_vit_tpu_torch.training import make_train_step

torch.set_num_threads(1)

VARIANT = "tiny16"
ADAMW = {"type": "AdamW", "lr": 1e-4, "weight_decay": 1e-4}
LOSS = {"type": "CombinedLoss"}


def _tree(size, seed=0):
    """A seeded flax tree of tiny16 at ``size``: the port's flax-default
    init, exported (no JAX init to compile)."""
    model = init_weights(ViTClassifier(VARIANT, image_size=size), seed)
    return export_flax_variables(model)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _images(n, size, seed):
    return np.random.default_rng(seed).normal(0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [64, 32])
def test_vit_matches_jax_float32(size):
    v = _tree(size)
    x = _images(3, size, size)
    jm = JViT(variant=VARIANT, image_size=size)
    jlogits, jfeats = jax.device_get(jax.jit(
        lambda v, x: jm.apply(v, x, return_features=True))(v, jnp.asarray(x)))
    model = create_model_from_config({"type": "vit", "feature_extractor": {
        "variant": VARIANT, "image_size": size}, "classifier": {"num_classes": 2}})
    assert isinstance(model, ViTClassifier) and model.feature_dim == 192
    load_flax_variables(model, v)
    with torch.no_grad():
        logits, feats = model.eval()(torch.from_numpy(x))
        probs = model.predict(torch.from_numpy(x))
    assert logits.dtype == feats.dtype == torch.float32 and feats.shape == (3, 192)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(probs.numpy(), torch.softmax(logits, -1).numpy(), rtol=1e-6)


def test_vit_bf16_probabilities_match_jax():
    size = 64
    v = _tree(size)
    x = _images(6, size, 5)
    jm = JViT(variant=VARIANT, image_size=size, dtype=jnp.bfloat16)
    compiled = jax.jit(lambda v, x: jm.apply(v, x, method=jm.predict)).lower(
        v, jnp.asarray(x)).compile(compiler_options={"xla_allow_excess_precision": False})
    jprobs = np.asarray(jax.device_get(compiled(v, jnp.asarray(x))), np.float32)
    model = load_flax_variables(ViTClassifier(VARIANT, image_size=size, dtype=torch.bfloat16), v)
    with torch.no_grad():
        probs = model.eval().predict(torch.from_numpy(x)).numpy()
    assert np.ptp(jprobs[:, 1]) > 0.3, "the probabilities spread over (0, 1)"
    np.testing.assert_allclose(probs, jprobs, atol=0.03)


def _hf_state_dict(size, seed=0):
    """A HuggingFace ViTForImageClassification state dict of tiny16's shapes."""
    cfg = VIT_CONFIGS[VARIANT]
    W, M, P = cfg["width"], cfg["mlp"], cfg["patch"]
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0, 0.05, s).astype(np.float32)  # noqa: E731
    sd = {"vit.embeddings.cls_token": r(1, 1, W),
          "vit.embeddings.position_embeddings": r(1, (size // P) ** 2 + 1, W),
          "vit.embeddings.patch_embeddings.projection.weight": r(W, 3, P, P),
          "vit.embeddings.patch_embeddings.projection.bias": r(W),
          "vit.layernorm.weight": 1 + r(W), "vit.layernorm.bias": r(W),
          "classifier.weight": r(2, W), "classifier.bias": r(2)}
    for i in range(cfg["depth"]):
        src = f"vit.encoder.layer.{i}"
        for n in ("attention.attention.query", "attention.attention.key",
                  "attention.attention.value", "attention.output.dense"):
            sd[f"{src}.{n}.weight"], sd[f"{src}.{n}.bias"] = r(W, W), r(W)
        sd[f"{src}.intermediate.dense.weight"], sd[f"{src}.intermediate.dense.bias"] = r(M, W), r(M)
        sd[f"{src}.output.dense.weight"], sd[f"{src}.output.dense.bias"] = r(W, M), r(W)
        for n in ("layernorm_before", "layernorm_after"):
            sd[f"{src}.{n}.weight"], sd[f"{src}.{n}.bias"] = 1 + r(W), r(W)
    return sd


def test_convert_hf_vit_matches_jax():
    size = 32
    sd = {k: torch.from_numpy(x) for k, x in _hf_state_dict(size).items()}
    got, want = _flat(convert_hf_vit(sd, VARIANT)), _flat(j_convert_hf_vit(sd, VARIANT))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k

    model = load_hf_vit(ViTClassifier(VARIANT, image_size=size), sd)
    assert torch.equal(model.block_3.attn.qkv_weight[192:384],
                       sd["vit.encoder.layer.3.attention.attention.key.weight"])


def test_bridge_round_trip_and_strictness():
    v = _tree(32, seed=3)
    jshapes = jax.eval_shape(JViT(variant=VARIANT, image_size=32).init,
                             {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                             jnp.zeros((1, 32, 32, 3)))
    assert set(jshapes) == {"params"}
    jflat = {jax.tree_util.keystr(kp, simple=True, separator="/"): x.shape
             for kp, x in jax.tree_util.tree_leaves_with_path(jshapes["params"])}
    assert jflat == {k: x.shape for k, x in _flat(v["params"]).items()}
    v = jax.tree_util.tree_map(lambda x: x + np.float32(0.25), v)  # not the values it had
    model = load_flax_variables(ViTClassifier(VARIANT, image_size=32), v)
    out = export_flax_variables(model)
    assert out["batch_stats"] == {}
    got, want = _flat(out["params"]), _flat(v["params"])
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # The seeded init has flax's kinds of values: zeros for the CLS token,
    # N(0, 0.02) for the positions, unit LayerNorm scales.
    seeded = init_weights(ViTClassifier(VARIANT, image_size=32), 0)
    assert not seeded.cls_token.detach().any()
    assert 0.015 < float(seeded.pos_embed.detach().std()) < 0.025
    assert torch.equal(seeded.block_0.ln1.weight, torch.ones(192))

    missing = {"params": {k: w for k, w in v["params"].items() if k != "cls_token"}}
    with pytest.raises(KeyError):
        load_flax_variables(ViTClassifier(VARIANT, image_size=32), missing)
    with pytest.raises(ValueError):  # 64² has 17 positions, 32² has 5
        load_flax_variables(ViTClassifier(VARIANT, image_size=64), v)
    extra = {"params": {**v["params"], "stray": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError):
        load_flax_variables(ViTClassifier(VARIANT, image_size=32), extra)


def _grads_tree(model):
    shadow = ViTClassifier(VARIANT, image_size=model.image_size)
    with torch.no_grad():
        for p, q in zip(model.parameters(), shadow.parameters()):
            q.copy_(p.grad)
    return export_flax_variables(shadow)["params"]


def test_adamw_step_matches_jax():
    size, n = 32, 4
    rng = np.random.default_rng(7)
    batch = {"image": _images(n, size, 8), "label": np.array([0, 1, 1, 0], np.int32),
             "landmarks": rng.uniform(4, 28, (n, 5, 2)).astype(np.float32)}
    class_weights = np.array([0.8, 1.3], np.float32)
    v = _tree(size, seed=4)

    jm = JViT(variant=VARIANT, image_size=size)
    tx = jcreate_optimizer(ADAMW, gradient_clip=1.0)
    jstate = JState.create(v["params"], {}, jax.jit(tx.init)(v["params"]))
    jstep = jmake_train_step(jm, jmake_criterion(LOSS, jnp.asarray(class_weights)), tx,
                             donate=False)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()},
                             jax.random.PRNGKey(5))
    jmetrics = jax.tree_util.tree_map(float, jmetrics)

    model = load_flax_variables(ViTClassifier(VARIANT, image_size=size), v)
    opt = create_optimizer(model.parameters(), ADAMW, gradient_clip=1.0)
    step = make_train_step(model, make_criterion(LOSS, torch.from_numpy(class_weights)), opt)
    metrics = {k: float(x) for k, x in step(TrainState(), batch, 5).items()}
    assert abs(metrics["loss"] - jmetrics["loss"]) <= 1e-4 * abs(jmetrics["loss"])
    assert abs(metrics["grad_norm"] - jmetrics["grad_norm"]) <= 1e-4 * jmetrics["grad_norm"]

    grads = _flat(_grads_tree(model))
    gmax = max(np.abs(g).max() for g in grads.values())
    zero_grad = {k for k, g in grads.items() if np.abs(g).max() < 1e-5 * gmax}
    assert zero_grad == {f"block_{i}/attn/key/bias" for i in range(12)}
    params, ref = _flat(export_flax_variables(model)["params"]), _flat(
        jax.device_get(jstate.params))
    for k in ref:
        err = np.abs(params[k] - ref[k]).max()
        limit = 2 * ADAMW["lr"] if k in zero_grad else 1e-4 * max(np.abs(ref[k]).max(), 1.0)
        assert err <= limit, (k, err)


# ---------------------------------------------------------------------------
# Serving a ViT: the HOG + ViT fallback predictor and FusedPipeline
# ---------------------------------------------------------------------------

FACE = 64
VIT_CFG = {"model": {"type": "vit", "feature_extractor": {"variant": VARIANT, "image_size": FACE},
                     "classifier": {"num_classes": 2}}}
HOG_PRE = {"detection": {"model": "hog", "confidence_threshold": 0.5,
                         "scrfd": {"input_size": [320, 320]}},
           "alignment": {"output_size": [FACE, FACE]}}


class _JitInit:
    """A flax module whose ``init`` runs jitted (the values are replaced)."""

    def __init__(self, module):
        self._module, self.init = module, jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


def test_hog_vit_predictor_matches_jax(tmp_path):
    """The reference's fallback stack, ``detection.model: hog`` +
    ``model.type: vit``, on rendered 320² scenes: ``num_faces`` equal and
    ``fake_prob`` within 0.02 (``tests/test_torch_inference.py``'s bound).
    The JAX aligner takes its CPU path, the exact float32 warp, which the
    port's bf16-tap warp follows within two grey levels. (Its TPU path,
    the Pallas warp, run in interpret mode on these frames returns values
    far above 255 wherever a face's source box lies some 100 px or more
    from the frame's origin; see ROADMAP, kept differences.)"""
    import deepfake_vit_tpu.inference as jinference

    from deepfake_vit_tpu.data.synth_faces import render_scene
    from deepfake_vit_tpu_torch.inference import PACKAGED_FORMAT, DeepfakePredictor
    from deepfake_vit_tpu_torch.models.hog_detector import HogFaceDetector
    from deepfake_vit_tpu_torch.utils.msgpack import msgpack_serialize

    tree = _tree(FACE, seed=6)
    rng = np.random.default_rng(99)
    clip = [render_scene(rng, size=320, max_faces=1, min_face=60, max_face=150, p_empty=0.0)[0]
            for _ in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        orig = jinference.create_model_from_config
        mp.setattr(jinference, "create_model_from_config",
                   lambda *a, **k: _JitInit(orig(*a, **k)))
        jpred = jinference.DeepfakePredictor(VIT_CFG, HOG_PRE, max_batch=4, dtype=jnp.float32)
    jpred.state = jpred.state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                                    tree["params"]))
    ref = jpred.predict_frames(clip)

    pred = DeepfakePredictor(VIT_CFG, HOG_PRE, max_batch=4, dtype=torch.float32, device="cpu")
    assert isinstance(pred.model, ViTClassifier) and isinstance(pred.detector, HogFaceDetector)
    pred.load_variables(tree)
    got = pred.predict_frames(clip)
    assert got["num_faces"] == ref["num_faces"] == 3
    assert abs(got["fake_prob"] - ref["fake_prob"]) <= 0.02
    np.testing.assert_allclose(got["frame_probs"], ref["frame_probs"], atol=0.02)

    # A packaged ViT rebuilds its architecture from the file alone.
    path = tmp_path / "vit.msgpack"
    path.write_bytes(msgpack_serialize({"format": PACKAGED_FORMAT, "face_size": FACE,
                                        "model_config": VIT_CFG["model"], **tree}))
    packaged = DeepfakePredictor.from_packaged(str(path), {"detection": HOG_PRE["detection"]},
                                               max_batch=4, dtype=torch.float32, device="cpu")
    assert isinstance(packaged.model, ViTClassifier) and packaged.aligner.output_size == (FACE,) * 2
    assert packaged.predict_frames(clip) == got


def test_fused_pipeline_with_vit_matches_jax(monkeypatch):
    """FusedPipeline at its default warp (pooled window 160) with a ViT:
    serving 256², a 128² detection canvas, 64² faces, float32, on rendered
    faces; the JAX pipeline with its Pallas crop and warp in interpret
    mode. ``has_face`` equal, boxes and landmarks within 1e-2 px,
    ``fake_prob`` within 0.02 (``tests/test_torch_e2e.py``'s bounds)."""
    from functools import partial

    from jax.experimental.pallas import tpu as pltpu

    import deepfake_vit_tpu.e2e as je2e
    from deepfake_vit_tpu.data.synth_faces import render_scene
    from deepfake_vit_tpu.ops.warp import warp_affine_windowed
    from deepfake_vit_tpu_torch.e2e import FusedPipeline
    from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path
    from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore

    common = dict(detection_input_size=(128, 128), serving_size=(256, 256),
                  output_size=(FACE, FACE), confidence_threshold=0.0)
    rng = np.random.default_rng(3)
    frames = np.stack([render_scene(rng, size=256, max_faces=1, p_empty=0.0, min_face=60,
                                    max_face=140)[0] for _ in range(4)])
    tree = _tree(FACE, seed=8)
    det_vars = msgpack_restore(default_weights_path("scrfd"))

    jpipe = je2e.FusedPipeline(VIT_CFG, dtype=jnp.float32, **common)
    monkeypatch.setattr(je2e, "warp_affine_windowed",
                        partial(warp_affine_windowed, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.device_get(jax.jit(jpipe._graph)(det_vars, tree, jnp.asarray(frames)))

    pipe = FusedPipeline(VIT_CFG, dtype=torch.float32, device="cpu", **common)
    assert (pipe.warp_window, pipe.warp_fractional, pipe._windowed) == (160, False, True)
    pipe.load_variables(seed=0)
    load_flax_variables(pipe.model, tree)
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}
    assert set(out) == set(ref)
    for k in out:
        assert out[k].shape == ref[k].shape, k
    assert out["features"].shape == (4, 192)
    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    assert ref["confidence"].min() > 0.9, "rendered faces give a clear best face"
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=1e-2)
    np.testing.assert_allclose(out["landmarks"], ref["landmarks"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=0.02)
    assert np.ptp(ref["fake_prob"]) > 0.05, "the seeded ViT tells the faces apart"


@pytest.mark.parametrize("option", ["use_fused_backbone", "use_int8_tail", "use_s2d_early"])
def test_fused_pipeline_refuses_efficientnet_options_with_vit(option):
    from deepfake_vit_tpu_torch.e2e import FusedPipeline

    with pytest.raises(ValueError, match=option):
        FusedPipeline(VIT_CFG, detection_input_size=(128, 128), output_size=(FACE, FACE),
                      device="cpu", **{option: True})


def test_train_and_evaluate_clis_take_a_vit(tmp_path):
    """``model.type: vit`` through the port's train and evaluate CLIs on the
    CPU (the JAX CLIs stop at a ``batch_stats`` lookup a ViT does not have):
    one epoch of tiny16 at 32² faces, its checkpoint evaluated."""
    import copy
    import json

    from deepfake_vit_tpu_torch import evaluate as evaluate_cli
    from deepfake_vit_tpu_torch import train as train_cli
    from deepfake_vit_tpu_torch.configs import TRAINING_CONFIG
    from deepfake_vit_tpu_torch.tools.synth_processed import write_processed
    from deepfake_vit_tpu_torch.utils.io_utils import load_checkpoint

    size = 32
    processed = write_processed(tmp_path / "processed", (8, 4, 4), size)
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["model"] = {"type": "vit", "feature_extractor": {"variant": VARIANT, "image_size": size},
                    "classifier": {"num_classes": 2}}
    cfg["data"].update(batch_size=4, num_workers=0, image_size=size)
    cfg["training"].update(num_epochs=1, use_amp=False)
    cfg["validation"]["save_freq"] = 1
    cfg["checkpoint"]["save_dir"] = str(tmp_path / "ckpt")
    cfg["logging"]["log_dir"] = str(tmp_path / "runs")
    path = tmp_path / "vit.json"
    path.write_text(json.dumps(cfg))
    common = ["--config", str(path), "--processed-dir", str(processed), "--device", "cpu"]
    assert train_cli.main(common) == 0
    saved = tmp_path / "ckpt" / "checkpoint_epoch_0000.ckpt"
    ckpt = load_checkpoint(saved)
    assert ckpt["batch_stats"] == {} and ckpt["params"]["cls_token"].shape == (1, 1, 192)
    assert evaluate_cli.main(["--checkpoint", str(saved), "--output-dir", str(tmp_path / "out")]
                             + common) == 0
    assert json.loads((tmp_path / "out" / "eval_test.json").read_text())[-1]["num_samples"] == 4
