"""TimeSformer clip classifier with divided space-time attention
(Bertasius, Wang and Torresani, arXiv:2102.05095; the layout of
``facebook/timesformer-base-finetuned-k400``), written plainly.

A clip of T frames, N patches a frame, width W. Tokens: one CLS vector
c = cls + pos[0] and z[n, t] = PatchConv(frame t)[n] + pos[1 + n] +
time[t], held patch-major (n, t) as the published implementation holds
them. Each pre-LayerNorm block (eps 1e-6):

- temporal: for each patch n, z[n, :] ← z[n, :] + Dense_td(Attn_t(LN_t(z[n, :])));
- spatial: for each frame t, a_t = Attn_s(LN_1([c; z[:, t]])), then
  c ← c + mean_t a_t[0] and z[:, t] ← z[:, t] + a_t[1:];
- MLP: x ← x + fc2(GELU(fc1(LN_2(x)))) on all 1 + N·T tokens, exact GELU.

Attn is multi-head self-attention with one QKV projection (with bias),
softmax(QKᵀ/√d)·V per head and an output projection. The verdict is a
linear head on the CLS vector after the final LayerNorm. Returns (logits,
that CLS vector), one row a clip. Weights under the program's state-dict
names (``param_spec``).

Departures from the published implementation: a ``num_classes`` head (2
here, 400 there); the time embedding is not interpolated, so a clip has
exactly the model's T frames; no dropout or drop-path (inference).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .nn import Operands, conv, layer_norm, linear

VARIANTS = {"base16": dict(patch=16, width=768, depth=12, heads=12, mlp=3072),
            "tiny8": dict(patch=8, width=64, depth=2, heads=2, mlp=256)}
LN_EPS = 1e-6


def param_spec(variant: str, image: int, frames: int, classes: int) -> List[Tuple[str, tuple, str]]:
    c = VARIANTS[variant]
    W, P, M = c["width"], c["patch"], c["mlp"]
    n = (image // P) ** 2 + 1
    spec = [("cls_token", (1, 1, W), "embed"), ("pos_embed", (1, n, W), "embed"),
            ("time_embed", (1, frames, W), "embed"),
            ("patch_embed.weight", (W, 3, P, P), "fan_in"), ("patch_embed.bias", (W,), "bias")]
    for i in range(c["depth"]):
        p = f"block_{i}"
        spec += [(f"{p}.ln_t.weight", (W,), "ln_weight"), (f"{p}.ln_t.bias", (W,), "ln_bias"),
                 (f"{p}.attn_t.qkv_weight", (3 * W, W), "fan_in"),
                 (f"{p}.attn_t.qkv_bias", (3 * W,), "bias"),
                 (f"{p}.attn_t.out_weight", (W, W), "fan_in"), (f"{p}.attn_t.out_bias", (W,), "bias"),
                 (f"{p}.dense_t.weight", (W, W), "fan_in"), (f"{p}.dense_t.bias", (W,), "bias"),
                 (f"{p}.ln1.weight", (W,), "ln_weight"), (f"{p}.ln1.bias", (W,), "ln_bias"),
                 (f"{p}.attn.qkv_weight", (3 * W, W), "fan_in"), (f"{p}.attn.qkv_bias", (3 * W,), "bias"),
                 (f"{p}.attn.out_weight", (W, W), "fan_in"), (f"{p}.attn.out_bias", (W,), "bias"),
                 (f"{p}.ln2.weight", (W,), "ln_weight"), (f"{p}.ln2.bias", (W,), "ln_bias"),
                 (f"{p}.fc1.weight", (M, W), "fan_in"), (f"{p}.fc1.bias", (M,), "bias"),
                 (f"{p}.fc2.weight", (W, M), "fan_in"), (f"{p}.fc2.bias", (W,), "bias")]
    spec += [("ln_final.weight", (W,), "ln_weight"), ("ln_final.bias", (W,), "ln_bias"),
             ("head.weight", (classes, W), "fan_in"), ("head.bias", (classes,), "bias")]
    return spec


def attention(sd: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, heads: int,
              P: Operands) -> torch.Tensor:
    """Multi-head self-attention over the sequences of x (S, L, W)."""
    S, L, W = x.shape
    hd = W // heads
    qkv = linear(x, sd[f"{prefix}.qkv_weight"], P, sd[f"{prefix}.qkv_bias"])
    q, k, v = qkv.view(S, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    scores = P(P(q) @ P(k).transpose(-1, -2)) / math.sqrt(hd)
    o = P(P(torch.softmax(scores, -1)) @ P(v)).transpose(1, 2).reshape(S, L, W)
    return linear(o, sd[f"{prefix}.out_weight"], P, sd[f"{prefix}.out_bias"])


def temporal(sd: Dict[str, torch.Tensor], p: str, z: torch.Tensor, heads: int,
             P: Operands) -> torch.Tensor:
    """A block's temporal half on patch-major tokens z (C, N, T, W)."""
    C, N, T, W = z.shape
    h = attention(sd, f"{p}.attn_t", layer_norm(z.reshape(C * N, T, W), sd, f"{p}.ln_t", LN_EPS),
                  heads, P)
    return z + linear(h, sd[f"{p}.dense_t.weight"], P, sd[f"{p}.dense_t.bias"]).view(C, N, T, W)


def block(sd: Dict[str, torch.Tensor], p: str, c: torch.Tensor, z: torch.Tensor, heads: int,
          P: Operands):
    """One block on the CLS c (C, W) and the patch-major tokens z (C, N, T, W)."""
    C, N, T, W = z.shape
    z = temporal(sd, p, z, heads, P)
    frames = torch.cat([c[:, None, None, :].expand(C, T, 1, W), z.transpose(1, 2)], 2)
    a = attention(sd, f"{p}.attn", layer_norm(frames.reshape(C * T, 1 + N, W), sd, f"{p}.ln1",
                                              LN_EPS), heads, P).view(C, T, 1 + N, W)
    c = c + a[:, :, 0].mean(1)
    z = z + a[:, :, 1:].transpose(1, 2)
    x = torch.cat([c[:, None], z.reshape(C, N * T, W)], 1)
    h = F.gelu(linear(layer_norm(x, sd, f"{p}.ln2", LN_EPS), sd[f"{p}.fc1.weight"], P,
                      sd[f"{p}.fc1.bias"]))
    x = x + linear(h, sd[f"{p}.fc2.weight"], P, sd[f"{p}.fc2.bias"])
    return x[:, 0], x[:, 1:].reshape(C, N, T, W)


def embed(sd: Dict[str, torch.Tensor], images: torch.Tensor, variant: str, frames: int,
          P: Operands):
    """The CLS (C, W) and patch-major tokens (C, N, T, W) of (C·T, H, W, 3) faces."""
    c = VARIANTS[variant]
    W = c["width"]
    x = conv(images.permute(0, 3, 1, 2), sd["patch_embed.weight"], P, c["patch"],
             padding=(0, 0, 0, 0), bias=sd["patch_embed.bias"])
    x = x.flatten(2).transpose(1, 2) + sd["pos_embed"][:, 1:]  # (C·T, N, W)
    C, N = x.shape[0] // frames, x.shape[1]
    z = x.reshape(C, frames, N, W).transpose(1, 2) + sd["time_embed"][:, None]
    cls = (sd["cls_token"] + sd["pos_embed"][:, :1]).reshape(1, W).expand(C, W)
    return cls, z


def forward(sd: Dict[str, torch.Tensor], images: torch.Tensor, variant: str, frames: int,
            P: Operands):
    """images (C·T, H, W, 3) ImageNet-normalized, T = ``frames`` consecutive
    faces a clip. Returns (logits (C, classes), features (C, W))."""
    c, z = embed(sd, images, variant, frames, P)
    for i in range(VARIANTS[variant]["depth"]):
        c, z = block(sd, f"block_{i}", c, z, VARIANTS[variant]["heads"], P)
    cls = layer_norm(c, sd, "ln_final", LN_EPS)
    return head(sd, cls, P), cls


def head(sd: Dict[str, torch.Tensor], features: torch.Tensor, P: Operands) -> torch.Tensor:
    """The linear head's logits from the (C, W) CLS features."""
    return linear(features, sd["head.weight"], P, sd["head.bias"])
