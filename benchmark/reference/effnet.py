"""EfficientNet (Tan & Le, arXiv:1905.11946) with the hybrid attention and
the MLP head of the deepfake classifier, written plainly.

Backbone: the B0 stage table scaled by the variant's width and depth
coefficients (channels rounded to multiples of 8, repeats ceiled), a 3×3
stride-2 stem, MBConv blocks (1×1 expansion, depthwise k×k, squeeze and
excitation from the block's input width / 4, 1×1 projection, residual when
the shape is kept), a 1×1 head conv;
TensorFlow 'SAME' padding, BatchNorm eps 1e-3 (momentum 0.99), SiLU.
Attention on the head's map: landmark Gaussians (σ 1.5, the five landmarks
scaled from 224² to the map, weighted, divided by the batch's largest value,
clipped to [0.1, 1]), channel attention (shared bias-free MLP of reduction
16 over the average and the maximum), spatial attention (7×7 bias-free conv
over the channel mean and maximum). Global average pool, then per hidden
width Dense → BatchNorm (eps 1e-5) → ReLU, and a final Dense: inference, with
no dropout.

Weights are a dict of float32 tensors under the state-dict names of
``param_spec``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .nn import Operands, batch_norm, conv, linear

B0_STAGES = ((1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24), (2, 5, 2, 6, 24, 40),
             (3, 3, 2, 6, 40, 80), (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192),
             (1, 3, 1, 6, 192, 320))
VARIANTS = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
            "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1)}
BN_EPS, HEAD_BN_EPS = 1e-3, 1e-5
SE_RATIO = 0.25
ATTN_REDUCTION = 16
LANDMARK_SIGMA, LANDMARK_INPUT = 1.5, 224.0


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def blocks(variant: str) -> List[dict]:
    width, depth = VARIANTS[variant]
    out = []
    for repeat, k, s, e, cin, cout in B0_STAGES:
        cin, cout = round_filters(cin, width), round_filters(cout, width)
        for i in range(int(math.ceil(depth * repeat))):
            out.append(dict(kernel=k, stride=s if i == 0 else 1, expand=e,
                            cin=cin if i == 0 else cout, cout=cout))
    return out


def feature_dim(variant: str) -> int:
    return round_filters(1280, VARIANTS[variant][0])


def param_spec(variant: str, hidden: Sequence[int], classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight and statistic, in the program's
    state-dict names. Kinds: ``fan_in`` (kernels), ``bias``, ``bn_*``
    (``bn_gain_pre`` the blocks' and the stem's BatchNorm scales before a
    SiLU, ``bn_gain`` the blocks' others), ``ones`` (the landmark
    weights)."""
    spec: List[Tuple[str, tuple, str]] = []

    def bn(name, c, gain="bn_weight"):
        spec.extend([(f"{name}.weight", (c,), gain), (f"{name}.bias", (c,), "bn_bias"),
                     (f"{name}.running_mean", (c,), "bn_mean"),
                     (f"{name}.running_var", (c,), "bn_var")])

    bb = "feature_extractor.backbone"
    stem = round_filters(32, VARIANTS[variant][0])
    spec.append((f"{bb}.stem_conv.weight", (stem, 3, 3, 3), "fan_in"))
    bn(f"{bb}.stem_bn", stem, "bn_gain_pre")
    for i, a in enumerate(blocks(variant)):
        p, cexp = f"{bb}.block_{i}", a["cin"] * a["expand"]
        if a["expand"] != 1:
            spec.append((f"{p}.expand_conv.weight", (cexp, a["cin"], 1, 1), "fan_in"))
            bn(f"{p}.bn0", cexp, "bn_gain_pre")
        spec.append((f"{p}.depthwise_conv.weight", (cexp, 1, a["kernel"], a["kernel"]), "fan_in"))
        bn(f"{p}.bn1", cexp, "bn_gain_pre")
        se = max(1, int(a["cin"] * SE_RATIO))
        spec += [(f"{p}.se_reduce.weight", (se, cexp, 1, 1), "fan_in"),
                 (f"{p}.se_reduce.bias", (se,), "bias"),
                 (f"{p}.se_expand.weight", (cexp, se, 1, 1), "fan_in"),
                 (f"{p}.se_expand.bias", (cexp,), "bias"),
                 (f"{p}.project_conv.weight", (a["cout"], cexp, 1, 1), "fan_in")]
        bn(f"{p}.bn2", a["cout"], "bn_gain")
    head = feature_dim(variant)
    spec.append((f"{bb}.head_conv.weight", (head, blocks(variant)[-1]["cout"], 1, 1), "fan_in"))
    bn(f"{bb}.head_bn", head)
    at = "feature_extractor.attention"
    spec += [(f"{at}.landmark_attn.attention_weights", (5,), "ones"),
             (f"{at}.channel_attn.fc1.weight", (head // ATTN_REDUCTION, head), "fan_in"),
             (f"{at}.channel_attn.fc2.weight", (head, head // ATTN_REDUCTION), "fan_in"),
             (f"{at}.spatial_attn.conv.weight", (1, 2, 7, 7), "fan_in")]
    cin = head
    for i, h in enumerate(hidden):
        spec += [(f"head_{i}.dense.weight", (h, cin), "fan_in"), (f"head_{i}.dense.bias", (h,), "bias")]
        bn(f"head_{i}.bn", h)
        cin = h
    spec += [("final.weight", (classes, cin), "fan_in"), ("final.bias", (classes,), "bias")]
    return spec


def landmark_map(landmarks: torch.Tensor, weights: torch.Tensor, size: Tuple[int, int]):
    """(N, 1, H, W) attention map of the five landmarks (224²-pixel
    coordinates) on an (H, W) feature map, normalized by the batch's max."""
    H, W = size
    lm = landmarks.float() * torch.tensor([W / LANDMARK_INPUT, H / LANDMARK_INPUT],
                                          device=landmarks.device)
    ys = torch.arange(H, dtype=torch.float32, device=landmarks.device)
    xs = torch.arange(W, dtype=torch.float32, device=landmarks.device)
    d2 = ((xs[None, None, None, :] - lm[..., 0, None, None]) ** 2
          + (ys[None, None, :, None] - lm[..., 1, None, None]) ** 2)
    amap = (torch.exp(-d2 / (2 * LANDMARK_SIGMA ** 2)) * weights[None, :, None, None]).sum(1, keepdim=True)
    return (amap / (amap.max() + 1e-8)).clamp(0.1, 1.0)


def forward(sd: Dict[str, torch.Tensor], images: torch.Tensor, landmarks: torch.Tensor,
            variant: str, hidden: Sequence[int], P: Operands, batch_stats: bool = False):
    """images (N, H, W, 3) ImageNet-normalized; landmarks (N, 5, 2) in face
    pixels. Returns (logits, features), float32. ``batch_stats``: every
    BatchNorm normalizes by the batch's statistics and stores them as its
    running statistics in ``sd`` (how the benchmark's weights get theirs)."""
    bb = "feature_extractor.backbone"

    def bn(x, name, eps=BN_EPS):
        return batch_norm(x, sd, name, eps, batch_stats)

    x = images.permute(0, 3, 1, 2)
    x = F.silu(bn(conv(x, sd[f"{bb}.stem_conv.weight"], P, 2), f"{bb}.stem_bn"))
    args = blocks(variant)
    for i, a in enumerate(args):
        p, inputs = f"{bb}.block_{i}", x
        if a["expand"] != 1:
            x = F.silu(bn(conv(x, sd[f"{p}.expand_conv.weight"], P), f"{p}.bn0"))
        x = F.silu(bn(conv(x, sd[f"{p}.depthwise_conv.weight"], P, a["stride"],
                           groups=x.shape[1]), f"{p}.bn1"))
        se = x.mean((2, 3), keepdim=True)
        se = F.silu(conv(se, sd[f"{p}.se_reduce.weight"], P, bias=sd[f"{p}.se_reduce.bias"]))
        se = conv(se, sd[f"{p}.se_expand.weight"], P, bias=sd[f"{p}.se_expand.bias"])
        x = bn(conv(x * torch.sigmoid(se), sd[f"{p}.project_conv.weight"], P), f"{p}.bn2")
        if a["stride"] == 1 and a["cin"] == a["cout"]:
            x = x + inputs
    x = F.silu(bn(conv(x, sd[f"{bb}.head_conv.weight"], P), f"{bb}.head_bn"))

    at = "feature_extractor.attention"
    x = x * landmark_map(landmarks, sd[f"{at}.landmark_attn.attention_weights"], x.shape[2:])
    fc1, fc2 = sd[f"{at}.channel_attn.fc1.weight"], sd[f"{at}.channel_attn.fc2.weight"]
    mlp = lambda v: linear(F.relu(linear(v, fc1, P)), fc2, P)  # noqa: E731
    x = x * torch.sigmoid(mlp(x.mean((2, 3))) + mlp(x.amax((2, 3))))[:, :, None, None]
    s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
    x = x * torch.sigmoid(conv(s, sd[f"{at}.spatial_attn.conv.weight"], P))

    features = x.mean((2, 3))
    return head(sd, features, hidden, P, batch_stats), features


def head(sd: Dict[str, torch.Tensor], features: torch.Tensor, hidden: Sequence[int], P: Operands,
         batch_stats: bool = False) -> torch.Tensor:
    """The MLP head's logits from (N, C) features."""
    h = features
    for i in range(len(hidden)):
        h = linear(h, sd[f"head_{i}.dense.weight"], P, sd[f"head_{i}.dense.bias"])
        h = F.relu(batch_norm(h, sd, f"head_{i}.bn", HEAD_BN_EPS, batch_stats))
    return linear(h, sd["final.weight"], P, sd["final.bias"])
