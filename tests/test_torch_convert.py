"""The port's checkpoint converters and their CLI against the JAX
package's, on the CPU.

The torch-layout inputs are made from the committed trained weights: the
b0 classifier (backbone, hybrid attention, [512, 128, 32] head) mapped to
the reference's ``DeepfakeDetectionModel`` layout and to the
efficientnet-pytorch layout by the inverse maps below, and the SCRFD
detector by ``export_scrfd_torch_layout`` of either package.

- The six entry points give the JAX functions' results:
  ``convert_efficientnet_backbone``, ``convert_detection_model`` and
  ``convert_scrfd_detector`` the same trees (``np.array_equal`` leaf by
  leaf, and equal to the trees the inputs were made from);
  ``export_scrfd_torch_layout`` the same state dict;
  ``load_torch_state_dict`` the same dict from a wrapped ``.pth``;
  ``assert_tree_shapes_match`` passes and raises where the JAX one does.
- The port's modules loaded straight from the state dicts
  (``load_reference_detection_model``, ``load_scrfd_detector``) give the
  JAX models' outputs on the converted trees, float32, within 1e-3 of
  each output's scale (as ``tests/test_torch_models.py``).
- ``python -m deepfake_vit_tpu_torch.convert_checkpoint`` against
  ``scripts/convert_checkpoint.py`` for each ``--kind`` (``vit`` from a
  state-dict file): each package restores the other's file, and the two
  trees are equal.
"""

import importlib.util
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_vit_tpu.models import convert as jconvert
from deepfake_vit_tpu.models.feature_extractor import create_model_from_config as jcreate
from deepfake_vit_tpu.models.scrfd import ScrfdDetector as JScrfd
from deepfake_vit_tpu.utils.io_utils import load_checkpoint as jload_checkpoint
from deepfake_vit_tpu_torch import convert_checkpoint as convert_cli
from deepfake_vit_tpu_torch.models import convert
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables
from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
from deepfake_vit_tpu_torch.models.scrfd import ScrfdDetector
from deepfake_vit_tpu_torch.models.vit import VIT_CONFIGS
from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path
from deepfake_vit_tpu_torch.utils.io_utils import load_checkpoint
from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CLASSIFIER = ROOT / "deepfake_vit_tpu" / "weights" / "classifier_synface.msgpack"
HIDDEN = (512, 128, 32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


def _oihw(k):
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _torch_bn(out, key, p, s):
    out[f"{key}.weight"], out[f"{key}.bias"] = p["scale"], p["bias"]
    out[f"{key}.running_mean"], out[f"{key}.running_var"] = s["mean"], s["var"]


def _efficientnet_layout(p, s, prefix=""):
    """EfficientNetBackbone variables → the efficientnet-pytorch layout."""
    out = {f"{prefix}_conv_stem.weight": _oihw(p["stem_conv"]["kernel"]),
           f"{prefix}_conv_head.weight": _oihw(p["head_conv"]["kernel"])}
    _torch_bn(out, f"{prefix}_bn0", p["stem_bn"], s["stem_bn"])
    _torch_bn(out, f"{prefix}_bn1", p["head_bn"], s["head_bn"])
    i = 0
    while f"block_{i}" in p:
        blk, st, src = p[f"block_{i}"], s[f"block_{i}"], f"{prefix}_blocks.{i}"
        for name in ("expand_conv", "depthwise_conv", "project_conv", "se_reduce", "se_expand"):
            if name in blk:
                out[f"{src}._{name}.weight"] = _oihw(blk[name]["kernel"])
                if "bias" in blk[name]:
                    out[f"{src}._{name}.bias"] = blk[name]["bias"]
        for bn in ("bn0", "bn1", "bn2"):
            if bn in blk:
                _torch_bn(out, f"{src}._{bn}", blk[bn], st[bn])
        i += 1
    return out


def _reference_layout(tree):
    """DeepfakeDetectionModel variables → the reference's torch layout."""
    p, s = tree["params"], tree["batch_stats"]
    out = _efficientnet_layout(p["feature_extractor"]["backbone"],
                               s["feature_extractor"]["backbone"],
                               "feature_extractor.backbone.backbone.")
    attn = p["feature_extractor"]["attention"]
    a = "feature_extractor.attention"
    out[f"{a}.landmark_attn.attention_weights"] = attn["landmark_attn"]["attention_weights"]
    out[f"{a}.channel_attn.fc.0.weight"] = attn["channel_attn"]["fc1"]["kernel"].T
    out[f"{a}.channel_attn.fc.2.weight"] = attn["channel_attn"]["fc2"]["kernel"].T
    out[f"{a}.spatial_attn.conv.weight"] = _oihw(attn["spatial_attn"]["conv"]["kernel"])
    for i in range(len(HIDDEN)):
        out[f"classifier.{4 * i}.weight"] = p[f"head_{i}"]["dense"]["kernel"].T
        out[f"classifier.{4 * i}.bias"] = p[f"head_{i}"]["dense"]["bias"]
        _torch_bn(out, f"classifier.{4 * i + 1}", p[f"head_{i}"]["bn"], s[f"head_{i}"]["bn"])
    out[f"classifier.{4 * len(HIDDEN)}.weight"] = p["final"]["kernel"].T
    out[f"classifier.{4 * len(HIDDEN)}.bias"] = p["final"]["bias"]
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def classifier():
    ck = msgpack_restore(CLASSIFIER)
    tree = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    return tree, ck["model_config"], _reference_layout(tree)


@pytest.fixture(scope="module")
def scrfd():
    tree = msgpack_restore(default_weights_path("scrfd"))
    return tree, jconvert.export_scrfd_torch_layout(tree)


def _close(port, ref, rel=1e-3):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert np.abs(port - ref).max() <= rel * max(np.abs(ref).max(), 1e-6)


def test_efficientnet_and_detection_model_converters_match_jax(classifier):
    tree, _, sd = classifier
    prefix = "feature_extractor.backbone.backbone."
    bare = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    got = convert.convert_efficientnet_backbone(bare, "b0")
    want = jconvert.convert_efficientnet_backbone(bare, "b0")
    _assert_trees_equal({"p": got[0], "s": got[1]}, {"p": want[0], "s": want[1]})
    _assert_trees_equal({"p": got[0], "s": got[1]},
                        {"p": tree["params"]["feature_extractor"]["backbone"],
                         "s": tree["batch_stats"]["feature_extractor"]["backbone"]})
    prefixed = convert.convert_efficientnet_backbone(sd, "b0", prefix=prefix)
    _assert_trees_equal({"p": prefixed[0]}, {"p": got[0]})

    got = convert.convert_detection_model(sd, "b0", HIDDEN)
    _assert_trees_equal(got, jconvert.convert_detection_model(sd, "b0", HIDDEN))
    _assert_trees_equal(got, tree)


def test_scrfd_converters_match_jax(scrfd):
    tree, sd = scrfd
    port_sd = convert.export_scrfd_torch_layout(tree)
    assert set(port_sd) == set(sd)
    for k in sd:
        assert np.array_equal(port_sd[k], sd[k]), k
    got = convert.convert_scrfd_detector(sd)
    _assert_trees_equal(got, jconvert.convert_scrfd_detector(sd))
    _assert_trees_equal(got, tree)


def test_load_torch_state_dict_and_tree_shapes_match_jax(classifier, tmp_path):
    _, _, sd = classifier
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    got, want = convert.load_torch_state_dict(str(path)), jconvert.load_torch_state_dict(str(path))
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k], sd[k]), k

    conv = convert.convert_detection_model(sd, "b0", HIDDEN)
    for fn in (convert.assert_tree_shapes_match, jconvert.assert_tree_shapes_match):
        fn(conv, conv)
        bad = {**conv, "params": {**conv["params"], "final": {
            "kernel": np.zeros((32, 3), np.float32), "bias": conv["params"]["final"]["bias"]}}}
        with pytest.raises(ValueError, match="shape mismatch at /params/final/kernel"):
            fn(bad, conv)
        with pytest.raises(ValueError, match="tree mismatch at /params"):
            fn({**conv, "params": {k: v for k, v in conv["params"].items() if k != "final"}},
               conv)


def test_loaded_modules_match_jax_models(classifier, scrfd):
    tree, model_config, sd = classifier
    conv = convert.convert_detection_model(sd, "b0", HIDDEN)
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    lms = rng.uniform(8, 56, (2, 5, 2)).astype(np.float32)
    jm = jcreate(model_config)
    jlogits, jfeats = jax.jit(lambda v, x, lm: jm.apply(v, x, lm, return_features=True))(
        conv, jnp.asarray(images), jnp.asarray(lms))
    model = convert.load_reference_detection_model(create_model_from_config(model_config), sd)
    with torch.no_grad():
        logits, feats = model.eval()(torch.from_numpy(images), torch.from_numpy(lms))
    _close(logits.numpy(), jlogits)
    _close(feats.numpy(), jfeats)

    det_tree, det_sd = scrfd
    frames = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    jouts = jax.jit(JScrfd().apply)(convert.convert_scrfd_detector(det_sd), jnp.asarray(frames))
    det = convert.load_scrfd_detector(ScrfdDetector(), det_sd).eval()
    with torch.no_grad():
        outs = det(torch.from_numpy(frames))
    for stride in outs:
        for key in outs[stride]:
            _close(outs[stride][key].numpy(), jouts[stride][key])


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoint",
                                                  ROOT / "scripts" / "convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hf_vit_state_dict():
    cfg = VIT_CONFIGS["tiny16"]
    W, M = cfg["width"], cfg["mlp"]
    rng = np.random.default_rng(1)
    r = lambda *s: torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32))  # noqa: E731
    sd = {"vit.embeddings.cls_token": r(1, 1, W), "vit.embeddings.position_embeddings": r(1, 5, W),
          "vit.embeddings.patch_embeddings.projection.weight": r(W, 3, 16, 16),
          "vit.embeddings.patch_embeddings.projection.bias": r(W),
          "vit.layernorm.weight": r(W), "vit.layernorm.bias": r(W),
          "classifier.weight": r(2, W), "classifier.bias": r(2)}
    for i in range(cfg["depth"]):
        src = f"vit.encoder.layer.{i}"
        for n, shape in (("attention.attention.query", (W, W)), ("attention.attention.key", (W, W)),
                         ("attention.attention.value", (W, W)),
                         ("attention.output.dense", (W, W)), ("intermediate.dense", (M, W)),
                         ("output.dense", (W, M))):
            sd[f"{src}.{n}.weight"], sd[f"{src}.{n}.bias"] = r(*shape), r(shape[0])
        for n in ("layernorm_before", "layernorm_after"):
            sd[f"{src}.{n}.weight"], sd[f"{src}.{n}.bias"] = r(W), r(W)
    return sd


@pytest.mark.parametrize("kind", ["backbone", "model", "vit", "detector"])
def test_convert_checkpoint_cli_matches_jax(kind, classifier, scrfd, tmp_path, monkeypatch):
    _, _, model_sd = classifier
    if kind == "backbone":
        prefix = "feature_extractor.backbone.backbone."
        sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in model_sd.items()
              if k.startswith(prefix)}
        flags = ["--variant", "b0"]
    elif kind == "model":
        sd = {k: torch.from_numpy(v) for k, v in model_sd.items()}
        flags = ["--variant", "b0", "--hidden-dims", *map(str, HIDDEN)]
    elif kind == "vit":
        sd, flags = _hf_vit_state_dict(), ["--variant", "tiny16"]
    else:
        sd, flags = {k: torch.from_numpy(v) for k, v in scrfd[1].items()}, []
    src = tmp_path / "in.pth"
    torch.save({"state_dict": sd}, src)
    port_out, jax_out = tmp_path / "port" / "out.ckpt", tmp_path / "jax" / "out.ckpt"
    assert convert_cli.main(["--input", str(src), "--output", str(port_out), "--kind", kind,
                             *flags]) == 0
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", "--input", str(src), "--output",
                                      str(jax_out), "--kind", kind, *flags])
    _jax_cli().main()

    if kind == "detector":  # msgpack of the variables, FaceDetector.load_weights' format
        got = flax.serialization.msgpack_restore(port_out.read_bytes())
        want = msgpack_restore(jax_out)
        assert port_out.read_bytes() == jax_out.read_bytes()
        load_flax_variables(ScrfdDetector(), got)  # the port's detector reads it
    else:
        got, want = jload_checkpoint(port_out), load_checkpoint(jax_out)
        assert set(got) == set(want) == {"epoch", "params", "batch_stats", "opt_state", "source"}
        assert got["epoch"] == want["epoch"] == 0 and got["source"] == want["source"]
        assert got["opt_state"] == want["opt_state"] == {}
    _assert_trees_equal({k: got[k] for k in ("params", "batch_stats")},
                        {k: want[k] for k in ("params", "batch_stats")})
