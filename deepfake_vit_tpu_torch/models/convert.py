"""Torch checkpoints of the reference's layouts → flax variable trees, and
direct loads into the port's modules.

Counterpart of the JAX package's ``models/convert.py``; each converter
returns the tree the JAX function returns, so either package loads what
the other converts:

1. ``convert_efficientnet_backbone``: an efficientnet-pytorch ImageNet
   state dict (``_conv_stem`` / ``_blocks.N._*`` / ``_conv_head``) →
   ``(params, batch_stats)`` of ``EfficientNetBackbone``;
2. ``convert_detection_model``: a full reference ``DeepfakeDetectionModel``
   state dict (``feature_extractor.backbone.backbone.*``, the hybrid
   attention at ``feature_extractor.attention.*``, the head Sequential at
   ``classifier.*``) → ``{"params", "batch_stats"}``;
3. ``convert_scrfd_detector``: an SCRFD-style detector state dict →
   ``ScrfdDetector`` variables, with ``export_scrfd_torch_layout`` its
   exact inverse.

Layouts: OIHW convolution kernels → HWIO, depthwise (C, 1, kh, kw) →
(kh, kw, 1, C), linear (out, in) → (in, out), BatchNorm
``weight/bias/running_mean/running_var`` → ``scale/bias`` and
``mean/var``. ``load_reference_detection_model`` and ``load_scrfd_detector``
load a converted state dict straight into the port's modules
(``models/bridge.py``, strict).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from .bridge import load_flax_variables
from .efficientnet import block_args


def _np(t: Any) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _conv(w: Any) -> np.ndarray:
    """OIHW → HWIO (also depthwise (C, 1, kh, kw) → (kh, kw, 1, C))."""
    return _np(w).transpose(2, 3, 1, 0)


def _linear(w: Any) -> np.ndarray:
    """(out, in) → (in, out)."""
    return _np(w).transpose(1, 0)


def _bn(sd: Mapping[str, Any], prefix: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    return ({"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])},
            {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])})


def convert_efficientnet_backbone(state_dict: Mapping[str, Any], variant: str = "b4",
                                  prefix: str = "") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """efficientnet-pytorch state dict → (params, batch_stats) of
    ``EfficientNetBackbone``. ``prefix`` strips a leading module path (e.g.
    ``feature_extractor.backbone.backbone.``)."""
    sd = state_dict
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {"stem_conv": {"kernel": _conv(sd["_conv_stem.weight"])}}
    stats: Dict[str, Any] = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "_bn0")
    for i, args in enumerate(block_args(variant)):
        src = f"_blocks.{i}"
        blk: Dict[str, Any] = {}
        blk_stats: Dict[str, Any] = {}
        if args["expand_ratio"] != 1:
            blk["expand_conv"] = {"kernel": _conv(sd[f"{src}._expand_conv.weight"])}
            blk["bn0"], blk_stats["bn0"] = _bn(sd, f"{src}._bn0")
        blk["depthwise_conv"] = {"kernel": _conv(sd[f"{src}._depthwise_conv.weight"])}
        blk["bn1"], blk_stats["bn1"] = _bn(sd, f"{src}._bn1")
        if args["se_ratio"] > 0:
            for name in ("se_reduce", "se_expand"):
                blk[name] = {"kernel": _conv(sd[f"{src}._{name}.weight"]),
                             "bias": _np(sd[f"{src}._{name}.bias"])}
        blk["project_conv"] = {"kernel": _conv(sd[f"{src}._project_conv.weight"])}
        blk["bn2"], blk_stats["bn2"] = _bn(sd, f"{src}._bn2")
        params[f"block_{i}"] = blk
        stats[f"block_{i}"] = blk_stats
    params["head_conv"] = {"kernel": _conv(sd["_conv_head.weight"])}
    params["head_bn"], stats["head_bn"] = _bn(sd, "_bn1")
    return params, stats


def convert_detection_model(state_dict: Mapping[str, Any], variant: str = "b4",
                            hidden_dims=(512, 128, 32)) -> Dict[str, Any]:
    """A full reference ``DeepfakeDetectionModel`` state dict → its flax
    variables. The head is a Sequential of [Linear, BN1d, ReLU, Dropout]
    per hidden width (Linear at 4i, BN at 4i + 1) and a final Linear at
    4 · len(hidden_dims); the attention's parts are converted where their
    keys are present."""
    sd = state_dict
    bb_params, bb_stats = convert_efficientnet_backbone(
        sd, variant, prefix="feature_extractor.backbone.backbone.")
    fe_params: Dict[str, Any] = {"backbone": bb_params}
    attn: Dict[str, Any] = {}
    lm_key = "feature_extractor.attention.landmark_attn.attention_weights"
    if lm_key in sd:
        attn["landmark_attn"] = {"attention_weights": _np(sd[lm_key])}
    ch = "feature_extractor.attention.channel_attn.fc"
    if f"{ch}.0.weight" in sd:
        attn["channel_attn"] = {"fc1": {"kernel": _linear(sd[f"{ch}.0.weight"])},
                                "fc2": {"kernel": _linear(sd[f"{ch}.2.weight"])}}
    sp = "feature_extractor.attention.spatial_attn.conv.weight"
    if sp in sd:
        attn["spatial_attn"] = {"conv": {"kernel": _conv(sd[sp])}}
    if attn:
        fe_params["attention"] = attn
    params: Dict[str, Any] = {"feature_extractor": fe_params}
    batch_stats: Dict[str, Any] = {"feature_extractor": {"backbone": bb_stats}}
    for i, _ in enumerate(hidden_dims):
        lin, bn = f"classifier.{4 * i}", f"classifier.{4 * i + 1}"
        bn_p, bn_s = _bn(sd, bn)
        params[f"head_{i}"] = {"dense": {"kernel": _linear(sd[f"{lin}.weight"]),
                                         "bias": _np(sd[f"{lin}.bias"])},
                               "bn": bn_p}
        batch_stats[f"head_{i}"] = {"bn": bn_s}
    final = f"classifier.{4 * len(hidden_dims)}"
    params["final"] = {"kernel": _linear(sd[f"{final}.weight"]), "bias": _np(sd[f"{final}.bias"])}
    return {"params": params, "batch_stats": batch_stats}


def convert_scrfd_detector(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """An SCRFD-style torch state dict → ``ScrfdDetector`` variables.

    The layout (``export_scrfd_torch_layout`` writes it):
    ``backbone.stem.{0,1}.conv.weight`` + ``.bn.*``;
    ``backbone.stage{s}.{b}.conv1.conv.weight`` + ``conv1.bn.*``,
    ``conv2.weight`` + ``bn2.*`` and, in a stage's projection block,
    ``downsample.conv.weight`` + ``downsample.bn.*``;
    ``neck.lateral.{3,4,5}.{weight,bias}``; ``neck.smooth.{0,1,2}.conv.weight``
    + ``.bn.*``; ``bbox_head.tower.{i}.conv.weight`` + ``.bn.*``;
    ``bbox_head.{cls,box,kps}.{weight,bias}``. Stage, block and tower counts
    come from the keys."""
    sd = state_dict
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def conv_bn(conv_key: str, bn_prefix: str) -> Tuple[Dict, Dict]:
        p_bn, s_bn = _bn(sd, bn_prefix)
        return ({"Conv_0": {"kernel": _conv(sd[conv_key])}, "BatchNorm_0": p_bn},
                {"BatchNorm_0": s_bn})

    for i in range(2):
        params[f"_ConvBN_{i}"], stats[f"_ConvBN_{i}"] = conv_bn(
            f"backbone.stem.{i}.conv.weight", f"backbone.stem.{i}.bn")
    flat_idx, s = 0, 1
    while f"backbone.stage{s}.0.conv1.conv.weight" in sd:
        b = 0
        while f"backbone.stage{s}.{b}.conv1.conv.weight" in sd:
            pre = f"backbone.stage{s}.{b}"
            blk_p: Dict[str, Any] = {}
            blk_s: Dict[str, Any] = {}
            blk_p["_ConvBN_0"], blk_s["_ConvBN_0"] = conv_bn(f"{pre}.conv1.conv.weight",
                                                             f"{pre}.conv1.bn")
            blk_p["Conv_0"] = {"kernel": _conv(sd[f"{pre}.conv2.weight"])}
            blk_p["BatchNorm_0"], blk_s["BatchNorm_0"] = _bn(sd, f"{pre}.bn2")
            if f"{pre}.downsample.conv.weight" in sd:
                blk_p["Conv_1"] = {"kernel": _conv(sd[f"{pre}.downsample.conv.weight"])}
                blk_p["BatchNorm_1"], blk_s["BatchNorm_1"] = _bn(sd, f"{pre}.downsample.bn")
            params[f"_ResBlock_{flat_idx}"] = blk_p
            stats[f"_ResBlock_{flat_idx}"] = blk_s
            flat_idx += 1
            b += 1
        s += 1
    for lvl in (3, 4, 5):
        params[f"lat{lvl}"] = {"kernel": _conv(sd[f"neck.lateral.{lvl}.weight"]),
                               "bias": _np(sd[f"neck.lateral.{lvl}.bias"])}
    for i in range(3):
        params[f"smooth{i}"], stats[f"smooth{i}"] = conv_bn(f"neck.smooth.{i}.conv.weight",
                                                            f"neck.smooth.{i}.bn")
    head_p: Dict[str, Any] = {}
    head_s: Dict[str, Any] = {}
    t = 0
    while f"bbox_head.tower.{t}.conv.weight" in sd:
        head_p[f"tower{t}"], head_s[f"tower{t}"] = conv_bn(f"bbox_head.tower.{t}.conv.weight",
                                                           f"bbox_head.tower.{t}.bn")
        t += 1
    for out in ("cls", "box", "kps"):
        head_p[out] = {"kernel": _conv(sd[f"bbox_head.{out}.weight"]),
                       "bias": _np(sd[f"bbox_head.{out}.bias"])}
    params["head"] = head_p
    stats["head"] = head_s
    return {"params": params, "batch_stats": stats}


def export_scrfd_torch_layout(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """``ScrfdDetector`` variables → the torch layout, the exact inverse of
    :func:`convert_scrfd_detector` (HWIO → OIHW etc.): the executable
    specification of the checkpoint naming."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}

    def put_conv(key: str, kernel) -> None:
        out[f"{key}.weight"] = _np(kernel).transpose(3, 2, 0, 1)

    def put_bn(key: str, p: Mapping, s: Mapping) -> None:
        out[f"{key}.weight"], out[f"{key}.bias"] = _np(p["scale"]), _np(p["bias"])
        out[f"{key}.running_mean"], out[f"{key}.running_var"] = _np(s["mean"]), _np(s["var"])

    def put_conv_bn(key: str, p: Mapping, s: Mapping) -> None:
        put_conv(f"{key}.conv", p["Conv_0"]["kernel"])
        put_bn(f"{key}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    for i in range(2):
        put_conv_bn(f"backbone.stem.{i}", params[f"_ConvBN_{i}"], stats[f"_ConvBN_{i}"])
    blocks = sorted((k for k in params if k.startswith("_ResBlock_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    # A projection (Conv_1) marks each stage's first block.
    s_idx, b_idx = 0, -1
    for name in blocks:
        p, st = params[name], stats[name]
        if "Conv_1" in p:
            s_idx, b_idx = s_idx + 1, 0
        else:
            b_idx += 1
        pre = f"backbone.stage{s_idx}.{b_idx}"
        put_conv_bn(f"{pre}.conv1", p["_ConvBN_0"], st["_ConvBN_0"])
        put_conv(f"{pre}.conv2", p["Conv_0"]["kernel"])
        put_bn(f"{pre}.bn2", p["BatchNorm_0"], st["BatchNorm_0"])
        if "Conv_1" in p:
            put_conv(f"{pre}.downsample.conv", p["Conv_1"]["kernel"])
            put_bn(f"{pre}.downsample.bn", p["BatchNorm_1"], st["BatchNorm_1"])
    for lvl in (3, 4, 5):
        put_conv(f"neck.lateral.{lvl}", params[f"lat{lvl}"]["kernel"])
        out[f"neck.lateral.{lvl}.bias"] = _np(params[f"lat{lvl}"]["bias"])
    for i in range(3):
        put_conv_bn(f"neck.smooth.{i}", params[f"smooth{i}"], stats[f"smooth{i}"])
    t = 0
    while f"tower{t}" in params["head"]:
        put_conv_bn(f"bbox_head.tower.{t}", params["head"][f"tower{t}"],
                    stats["head"][f"tower{t}"])
        t += 1
    for o in ("cls", "box", "kps"):
        put_conv(f"bbox_head.{o}", params["head"][o]["kernel"])
        out[f"bbox_head.{o}.bias"] = _np(params["head"][o]["bias"])
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` file as {name: numpy}, unwrapping a ``model_state_dict``,
    ``state_dict`` or ``model`` entry. The file is unpickled in full
    (``weights_only=False``, as the JAX function reads it): convert only
    checkpoints you trust."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {k: _np(v) for k, v in obj.items()}


def assert_tree_shapes_match(converted: Any, initialized: Any, path: str = "") -> None:
    """Raise with the offending path if the two trees differ in keys or shapes."""
    if isinstance(initialized, Mapping):
        missing = set(initialized) - set(converted)
        extra = set(converted) - set(initialized)
        if missing or extra:
            raise ValueError(f"tree mismatch at {path}: missing={missing} extra={extra}")
        for k in initialized:
            assert_tree_shapes_match(converted[k], initialized[k], f"{path}/{k}")
    elif tuple(np.shape(converted)) != tuple(np.shape(initialized)):
        raise ValueError(f"shape mismatch at {path}: {np.shape(converted)} vs "
                         f"{np.shape(initialized)}")


def load_reference_detection_model(model, state_dict: Mapping[str, Any]):
    """A reference ``DeepfakeDetectionModel`` state dict loaded into the
    port's ``DeepfakeDetectionModel`` (its variant and head widths);
    returns the model."""
    hidden = [getattr(model, f"head_{i}").dense.weight.shape[0] for i in range(model.n_hidden)]
    return load_flax_variables(model, convert_detection_model(state_dict, model.variant, hidden))


def load_scrfd_detector(detector, state_dict: Mapping[str, Any]):
    """An SCRFD-style state dict loaded into the port's ``ScrfdDetector``;
    returns the detector."""
    return load_flax_variables(detector, convert_scrfd_detector(state_dict))


__all__ = ["assert_tree_shapes_match", "convert_detection_model", "convert_efficientnet_backbone",
           "convert_scrfd_detector", "export_scrfd_torch_layout", "load_reference_detection_model",
           "load_scrfd_detector", "load_torch_state_dict"]
