"""Vision Transformer classifier (Dosovitskiy et al., arXiv:2010.11929; the
layout of ``google/vit-base-patch16-224``), written plainly.

A 16×16 stride-16 patch convolution with bias, a learned CLS token and
position embeddings, pre-LayerNorm encoder blocks (eps 1e-12): multi-head
self-attention (one QKV projection, softmax(QKᵀ/√d)·V per head, an output
projection) and an MLP with exact GELU, each added to the residual; a final
LayerNorm and a linear head on the CLS vector. Returns (logits, the CLS
vector after the final LayerNorm). Weights under the program's state-dict
names (``param_spec``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .nn import Operands, conv, layer_norm, linear

VARIANTS = {"base16": dict(patch=16, width=768, depth=12, heads=12, mlp=3072),
            "small16": dict(patch=16, width=384, depth=12, heads=6, mlp=1536),
            "tiny16": dict(patch=16, width=192, depth=12, heads=3, mlp=768)}
LN_EPS = 1e-12


def param_spec(variant: str, image: int, classes: int) -> List[Tuple[str, tuple, str]]:
    c = VARIANTS[variant]
    W, P, M = c["width"], c["patch"], c["mlp"]
    n = (image // P) ** 2 + 1
    spec = [("cls_token", (1, 1, W), "embed"), ("pos_embed", (1, n, W), "embed"),
            ("patch_embed.weight", (W, 3, P, P), "fan_in"), ("patch_embed.bias", (W,), "bias")]
    for i in range(c["depth"]):
        p = f"block_{i}"
        spec += [(f"{p}.ln1.weight", (W,), "ln_weight"), (f"{p}.ln1.bias", (W,), "ln_bias"),
                 (f"{p}.attn.qkv_weight", (3 * W, W), "fan_in"), (f"{p}.attn.qkv_bias", (3 * W,), "bias"),
                 (f"{p}.attn.out_weight", (W, W), "fan_in"), (f"{p}.attn.out_bias", (W,), "bias"),
                 (f"{p}.ln2.weight", (W,), "ln_weight"), (f"{p}.ln2.bias", (W,), "ln_bias"),
                 (f"{p}.fc1.weight", (M, W), "fan_in"), (f"{p}.fc1.bias", (M,), "bias"),
                 (f"{p}.fc2.weight", (W, M), "fan_in"), (f"{p}.fc2.bias", (W,), "bias")]
    spec += [("ln_final.weight", (W,), "ln_weight"), ("ln_final.bias", (W,), "ln_bias"),
             ("head.weight", (classes, W), "fan_in"), ("head.bias", (classes,), "bias")]
    return spec


def forward(sd: Dict[str, torch.Tensor], images: torch.Tensor, variant: str, P: Operands):
    """images (N, H, W, 3) ImageNet-normalized. Returns (logits, features)."""
    c = VARIANTS[variant]
    W, H = c["width"], c["heads"]
    hd = W // H
    x = conv(images.permute(0, 3, 1, 2), sd["patch_embed.weight"], P, c["patch"],
             padding=(0, 0, 0, 0), bias=sd["patch_embed.bias"])
    x = x.flatten(2).transpose(1, 2)
    N, L = x.shape[0], x.shape[1] + 1
    x = torch.cat([sd["cls_token"].expand(N, 1, W), x], 1) + sd["pos_embed"]
    for i in range(c["depth"]):
        p = f"block_{i}"
        h = layer_norm(x, sd, f"{p}.ln1", LN_EPS)
        qkv = linear(h, sd[f"{p}.attn.qkv_weight"], P, sd[f"{p}.attn.qkv_bias"])
        q, k, v = qkv.view(N, L, 3, H, hd).permute(2, 0, 3, 1, 4)
        scores = P(P(q) @ P(k).transpose(-1, -2)) / math.sqrt(hd)
        o = P(P(torch.softmax(scores, -1)) @ P(v)).transpose(1, 2).reshape(N, L, W)
        x = x + linear(o, sd[f"{p}.attn.out_weight"], P, sd[f"{p}.attn.out_bias"])
        h = layer_norm(x, sd, f"{p}.ln2", LN_EPS)
        h = F.gelu(linear(h, sd[f"{p}.fc1.weight"], P, sd[f"{p}.fc1.bias"]))
        x = x + linear(h, sd[f"{p}.fc2.weight"], P, sd[f"{p}.fc2.bias"])
    cls = layer_norm(x, sd, "ln_final", LN_EPS)[:, 0]
    return head(sd, cls, P), cls


def head(sd: Dict[str, torch.Tensor], features: torch.Tensor, P: Operands) -> torch.Tensor:
    """The linear head's logits from the (N, W) CLS features."""
    return linear(features, sd["head.weight"], P, sd["head.bias"])
