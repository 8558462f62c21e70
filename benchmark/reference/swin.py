"""Swin Transformer classifier (Liu et al., arXiv:2103.14030; the layout of
``microsoft/swin-base-patch4-window7-224``), written plainly.

A patch convolution with bias (4×4, stride 4) and a LayerNorm give a grid
of tokens; four stages of pre-LayerNorm blocks (eps 1e-5) follow, each
stage but the last ending in a patch merging. A block on an R×R grid:

- window attention: LN_1, then in odd blocks the grid rolled by (−s, −s),
  s = w // 2; cut into w×w windows; per window one QKV projection (with
  bias), per head softmax(QKᵀ/√d + B[h] + M[n])·V, the output projection;
  the windows put back, the grid rolled by (s, s), added to the residual.
  B[h] is a learned ((2w − 1)², heads) table read at each token pair's
  offset (Δy + w − 1)·(2w − 1) + Δx + w − 1; M[n] is −100 between tokens
  of window n that lie in different regions of the rolled grid, the regions
  cut at [0, R − w), [R − w, R − s), [R − s, R) on each axis, and 0
  elsewhere (unshifted blocks have none);
- MLP: x + fc2(GELU(fc1(LN_2(x)))), exact GELU, ratio 4.

Where the grid is no larger than the window the window is the grid and the
shift 0. Patch merging: the 2×2 neighbours (y, x), (y + 1, x), (y, x + 1),
(y + 1, x + 1) side by side in that order, LayerNorm over the 4C values, a
linear map to 2C without bias. The verdict is a linear head on the mean
token after the final LayerNorm. Returns (logits, that mean). Weights
under the program's state-dict names (``param_spec``).

Departures from the published implementation: a ``num_classes`` head (2
here, 1,000 there); grids that windows or merges do not tile are refused
rather than padded (none is at 224²); no dropout or drop path (inference).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .nn import Operands, conv, layer_norm, linear

VARIANTS = {"base4w7": dict(patch=4, embed=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
                            window=7),
            "tiny2w4": dict(patch=2, embed=16, depths=(2, 2, 2, 2), heads=(2, 4, 8, 16),
                            window=4)}
LN_EPS = 1e-5
MASK = -100.0


def stages(variant: str, image: int) -> List[dict]:
    """Per stage: grid side, width, heads, depth, window and the odd blocks' shift."""
    c = VARIANTS[variant]
    res, out = image // c["patch"], []
    for s, (depth, heads) in enumerate(zip(c["depths"], c["heads"])):
        window = min(c["window"], res)
        if res % window or (s < len(c["depths"]) - 1 and res % 2):
            raise ValueError(f"a {res}x{res} grid that windows of {window} or merging do not tile")
        out.append(dict(res=res, width=c["embed"] * 2 ** s, heads=heads, depth=depth,
                        window=window, shift=c["window"] // 2 if res > window else 0))
        res //= 2
    return out


def param_spec(variant: str, image: int, classes: int) -> List[Tuple[str, tuple, str]]:
    c = VARIANTS[variant]
    C, P = c["embed"], c["patch"]
    spec = [("patch_embed.weight", (C, 3, P, P), "fan_in"), ("patch_embed.bias", (C,), "bias"),
            ("embed_norm.weight", (C,), "ln_weight"), ("embed_norm.bias", (C,), "ln_bias")]
    plan = stages(variant, image)
    for s, st in enumerate(plan):
        W, H, w = st["width"], st["heads"], st["window"]
        for i in range(st["depth"]):
            p = f"stage_{s}.block_{i}"
            spec += [(f"{p}.ln1.weight", (W,), "ln_weight"), (f"{p}.ln1.bias", (W,), "ln_bias"),
                     (f"{p}.attn.qkv_weight", (3 * W, W), "fan_in"),
                     (f"{p}.attn.qkv_bias", (3 * W,), "bias"),
                     (f"{p}.attn.out_weight", (W, W), "fan_in"),
                     (f"{p}.attn.out_bias", (W,), "bias"),
                     (f"{p}.rel_bias", ((2 * w - 1) ** 2, H), "embed"),
                     (f"{p}.ln2.weight", (W,), "ln_weight"), (f"{p}.ln2.bias", (W,), "ln_bias"),
                     (f"{p}.fc1.weight", (4 * W, W), "fan_in"), (f"{p}.fc1.bias", (4 * W,), "bias"),
                     (f"{p}.fc2.weight", (W, 4 * W), "fan_in"), (f"{p}.fc2.bias", (W,), "bias")]
        if s < len(plan) - 1:
            p = f"stage_{s}.merge"
            spec += [(f"{p}.norm.weight", (4 * W,), "ln_weight"),
                     (f"{p}.norm.bias", (4 * W,), "ln_bias"),
                     (f"{p}.reduction.weight", (2 * W, 4 * W), "fan_in")]
    W = plan[-1]["width"]
    spec += [("ln_final.weight", (W,), "ln_weight"), ("ln_final.bias", (W,), "ln_bias"),
             ("head.weight", (classes, W), "fan_in"), ("head.bias", (classes,), "bias")]
    return spec


def windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(N, R, R, C) → (N, (R/w)², w·w, C): each window's tokens row-major."""
    N, R, _, C = x.shape
    return x.reshape(N, R // w, w, R // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(
        N, (R // w) ** 2, w * w, C)


def unwindows(x: torch.Tensor, R: int, w: int) -> torch.Tensor:
    """The inverse of :func:`windows`: → (N, R, R, C)."""
    N, _, _, C = x.shape
    return x.reshape(N, R // w, R // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(N, R, R, C)


def position_bias(table: torch.Tensor, w: int) -> torch.Tensor:
    """(heads, w·w, w·w): the table's row at each token pair's offset."""
    y = torch.arange(w, device=table.device).repeat_interleave(w)
    x = torch.arange(w, device=table.device).repeat(w)
    idx = (y[:, None] - y[None, :] + w - 1) * (2 * w - 1) + (x[:, None] - x[None, :] + w - 1)
    return table[idx].permute(2, 0, 1)


def region_mask(R: int, w: int, s: int, device) -> torch.Tensor:
    """((R/w)², w·w, w·w): 0 within a region of the rolled grid, −100 across."""
    bands = torch.zeros(R, dtype=torch.long, device=device)
    bands[R - w:R - s] = 1
    bands[R - s:] = 2
    region = (bands[:, None] * 3 + bands[None, :])[None, :, :, None]
    r = windows(region, w)[0, :, :, 0]
    return torch.where(r[:, :, None] == r[:, None, :], 0.0, MASK).to(device)


def window_attention(sd: Dict[str, torch.Tensor], p: str, h: torch.Tensor, st: dict,
                     shift: int, P: Operands) -> torch.Tensor:
    """A block's window attention on the normalized grid h (N, R, R, C)."""
    N, R, _, C = h.shape
    w, H = st["window"], st["heads"]
    d = C // H
    if shift:
        h = torch.roll(h, (-shift, -shift), (1, 2))
    t = windows(h, w)  # (N, nW, L, C)
    nW, L = t.shape[1], t.shape[2]
    qkv = linear(t, sd[f"{p}.attn.qkv_weight"], P, sd[f"{p}.attn.qkv_bias"])
    q, k, v = qkv.view(N, nW, L, 3, H, d).permute(3, 0, 1, 4, 2, 5)  # each (N, nW, H, L, d)
    scores = P(P(q) @ P(k).transpose(-1, -2)) / math.sqrt(d)
    scores = scores + position_bias(sd[f"{p}.rel_bias"], w)
    if shift:
        scores = scores + region_mask(R, w, shift, h.device)[:, None]
    o = P(P(torch.softmax(scores, -1)) @ P(v)).transpose(2, 3).reshape(N, nW, L, C)
    o = unwindows(linear(o, sd[f"{p}.attn.out_weight"], P, sd[f"{p}.attn.out_bias"]), R, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def block(sd: Dict[str, torch.Tensor], p: str, x: torch.Tensor, st: dict, shift: int,
          P: Operands) -> torch.Tensor:
    """One block on the grid x (N, R, R, C)."""
    x = x + window_attention(sd, p, layer_norm(x, sd, f"{p}.ln1", LN_EPS), st, shift, P)
    h = F.gelu(linear(layer_norm(x, sd, f"{p}.ln2", LN_EPS), sd[f"{p}.fc1.weight"], P,
                      sd[f"{p}.fc1.bias"]))
    return x + linear(h, sd[f"{p}.fc2.weight"], P, sd[f"{p}.fc2.bias"])


def merge(sd: Dict[str, torch.Tensor], p: str, x: torch.Tensor, P: Operands) -> torch.Tensor:
    """Patch merging: (N, R, R, C) → (N, R/2, R/2, 2C)."""
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return linear(layer_norm(x, sd, f"{p}.norm", LN_EPS), sd[f"{p}.reduction.weight"], P)


def forward(sd: Dict[str, torch.Tensor], images: torch.Tensor, variant: str, P: Operands):
    """images (N, H, W, 3) ImageNet-normalized. Returns (logits, features)."""
    c = VARIANTS[variant]
    x = conv(images.permute(0, 3, 1, 2), sd["patch_embed.weight"], P, c["patch"],
             padding=(0, 0, 0, 0), bias=sd["patch_embed.bias"]).permute(0, 2, 3, 1)
    x = layer_norm(x, sd, "embed_norm", LN_EPS)
    plan = stages(variant, images.shape[1])
    for s, st in enumerate(plan):
        for i in range(st["depth"]):
            x = block(sd, f"stage_{s}.block_{i}", x, st, st["shift"] if i % 2 else 0, P)
        if s < len(plan) - 1:
            x = merge(sd, f"stage_{s}.merge", x, P)
    feats = layer_norm(x, sd, "ln_final", LN_EPS).mean(dim=(1, 2))
    return head(sd, feats, P), feats


def head(sd: Dict[str, torch.Tensor], features: torch.Tensor, P: Operands) -> torch.Tensor:
    """The linear head's logits from the (N, C) mean features."""
    return linear(features, sd["head.weight"], P, sd["head.bias"])
