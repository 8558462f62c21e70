"""Swin Transformer classifier: windowed attention with a relative position
bias and shifted windows, over a hierarchy of four stages.

Liu et al., "Swin Transformer: Hierarchical Vision Transformer using
Shifted Windows" (ICCV 2021, arXiv:2103.14030), in the layout of
``microsoft/swin-base-patch4-window7-224``: patch 4, embedding width 128,
depths [2, 2, 18, 2], heads [4, 8, 16, 32] (32 values a head throughout),
windows of 7×7, MLP ratio 4 with exact GELU, QKV bias, LayerNorm eps 1e-5,
no absolute position embedding. The JAX package has no such family: this
one is the port's own, with no flax tree behind it.

For faces of S² pixels the tokens are a (S/4)² grid of width C: a 4×4
stride-4 convolution with bias, then ``LayerNorm(C)``. Each stage runs its
blocks on an R×R grid of width C_s and, but the last, merges 2×2
neighbours into an (R/2)² grid of width 2·C_s. A block on (B, R·R, C_s):

- window half: h = LN_1(x) as (B, R, R, C_s); in every second block
  (shift s = w // 2) rolled by (−s, −s); cut into (R/w)² windows of w×w
  tokens; per window and head softmax(q kᵀ / √hd + bias[h] + mask[n]) v,
  ``bias[h]`` the head's relative position bias (a ((2w − 1)², heads)
  table gathered by each token pair's offset), ``mask[n]`` −100 between
  tokens of different regions of the rolled grid (cut at [0 : −w],
  [−w : −s], [−s :] on each axis; shifted blocks only); the output
  projection; the windows put back and rolled by (s, s); x ← x + h;
- MLP half: x ← x + fc2(GELU(fc1(LN_2(x)))), fc1 C_s → 4·C_s.

Where a stage's grid is no larger than the window (Swin-B's last stage, 7×7)
the window is the whole grid and the shift 0, as both published
implementations have it. Patch merging: ``cat(x[0::2, 0::2], x[1::2, 0::2],
x[0::2, 1::2], x[1::2, 1::2])`` along the channels, ``LayerNorm(4·C_s)``,
a 4·C_s → 2·C_s product without bias. The verdict is ``head(mean over the
tokens of LN_f(x))``.

``forward(images, landmarks=None, backbone_start_block=0, generator=None)``
returns ``(logits, features)`` like the other families: both in float32
(float64 for a float64 model), ``features`` the token mean after the final
LayerNorm. Landmarks are accepted and unused. In train mode
(``module.train()``) dropout acts on the attention weights and after each
MLP, and drop path (stochastic depth, rising linearly over the blocks to
``DROP_PATH``) on both residual branches, drawing from ``generator``.

The attention core is ``ops/self_attention.py::self_attention_plain`` with
the bias and mask as its additive ``bias`` (the hand-written kernel takes
no bias, so it never engages here); LayerNorms of rows of at most 768
values take ``ops/layer_norm.py``'s kernel on the card, as everywhere.
While ``torch.profiler`` records, each block's window half (roll to roll
back) is a ``classify.window`` range holding the attention's
``classify.attention``, and each patch merging a ``classify.merge`` range.
The model counts on the host the window sequences it attends,
``windows``, and those under a shift mask, ``shifted_windows``.

``convert_hf_swin`` renames a HuggingFace ``SwinForImageClassification``
state dict to the port's names; ``load_hf_swin`` loads one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import annotate
from .layers import Conv, Dense, Dropout, LayerNorm, MultiHeadDotProductAttention, drop_connect

SWIN_CONFIGS = {
    "base4w7": dict(patch=4, embed=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), window=7),
    # The CPU tests' size: at 64² faces grids of 32, 16, 8 and 4 under windows
    # of 4, so the last stage's grid equals the window (shift 0, as Swin-B's).
    "tiny2w4": dict(patch=2, embed=16, depths=(2, 2, 2, 2), heads=(2, 4, 8, 16), window=4),
}
LN_EPS = 1e-5
MLP_RATIO = 4
MASK = -100.0  # the published value between tokens of different shift regions
DROP_PATH = 0.1  # the published configuration's stochastic depth at the last block


def stage_plan(variant: str, image_size: int) -> List[Dict[str, int]]:
    """Each stage's grid side ``res``, ``width``, ``heads``, ``depth``,
    ``window`` (clipped to the grid) and ``shift`` (of its odd blocks; 0
    where the window holds the whole grid)."""
    cfg = SWIN_CONFIGS[variant]
    if image_size % cfg["patch"]:
        raise ValueError(f"a Swin {variant} takes faces of a multiple of {cfg['patch']} pixels, "
                         f"not {image_size}")
    res, plan = image_size // cfg["patch"], []
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        window = min(cfg["window"], res)
        last = s == len(cfg["depths"]) - 1
        if res % window or (not last and res % 2):
            raise ValueError(f"a Swin {variant} at {image_size}² faces has a {res}² grid in stage "
                             f"{s}, which windows of {window} or a 2×2 merge do not tile")
        plan.append(dict(res=res, width=cfg["embed"] << s, heads=heads, depth=depth,
                         window=window, shift=cfg["window"] // 2 if res > window else 0))
        res //= 2
    return plan


def relative_index(window: int) -> torch.Tensor:
    """(w², w²) index into a ((2w − 1)², heads) bias table: token pair (i,
    j) of a window, row-major, at offset (Δy, Δx) = pos_i − pos_j reads row
    (Δy + w − 1) · (2w − 1) + Δx + w − 1."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    pos = torch.stack([ys.flatten(), xs.flatten()])  # (2, w²)
    d = pos[:, :, None] - pos[:, None, :] + (window - 1)
    return d[0] * (2 * window - 1) + d[1]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, R, R, C) → (B · (R/w)², w², C), windows row-major in each image."""
    B, H, W, C = x.shape
    x = x.view(B, H // window, window, W // window, window, C).transpose(2, 3)
    return x.reshape(-1, window * window, C)


def window_reverse(windows: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: → (B, H, W, C)."""
    C = windows.shape[-1]
    x = windows.view(-1, H // window, W // window, window, window, C).transpose(2, 3)
    return x.reshape(-1, H, W, C)


def shift_mask(res: int, window: int, shift: int) -> torch.Tensor:
    """(windows, w², w²) float32: 0 between tokens of one region of the
    grid rolled by (−shift, −shift), ``MASK`` between tokens of two."""
    region = torch.zeros(res, res)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    n = 0
    for ys in cuts:
        for xs in cuts:
            region[ys, xs] = n
            n += 1
    r = window_partition(region.view(1, res, res, 1), window)[..., 0]  # (windows, w²)
    return torch.where(r[:, :, None] == r[:, None, :], 0.0, MASK)


class SwinBlock(nn.Module):
    """The window half and the MLP half on (B, R·R, C) tokens."""

    def __init__(self, width: int, heads: int, res: int, window: int, shift: int,
                 dropout: float, drop_path: float):
        super().__init__()
        self.res, self.window, self.shift, self.drop_path = res, window, shift, drop_path
        self.n_windows = (res // window) ** 2
        self.ln1 = LayerNorm(width, LN_EPS)
        self.attn = MultiHeadDotProductAttention(width, heads, dropout)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("rel_index", relative_index(window), persistent=False)
        self.register_buffer("mask", shift_mask(res, window, shift) if shift else None,
                             persistent=False)
        self.ln2 = LayerNorm(width, LN_EPS)
        self.fc1 = Dense(width, MLP_RATIO * width)
        self.fc2 = Dense(MLP_RATIO * width, width)
        self.dropout = Dropout(dropout)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The block's own parameter: the relative position bias table,
        N(0, 0.02²) cut at ±2σ as published (its layers reset themselves)."""
        with torch.no_grad():
            self.rel_bias.copy_(0.02 * torch.randn(self.rel_bias.shape, generator=generator)
                                .clamp(-2.0, 2.0))

    def attention_bias(self) -> torch.Tensor:
        """(1, heads, w², w²) relative position bias, or with the shift
        (windows, heads, w², w²) bias plus each window's mask; float32."""
        L = self.window * self.window
        bias = self.rel_bias[self.rel_index.reshape(-1)].view(L, L, -1).permute(2, 0, 1)[None]
        return bias + self.mask[:, None] if self.shift else bias

    def window_half(self, h: torch.Tensor, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """Windowed attention on LN_1's output h (B, R·R, C), rolled and put back."""
        B, N, C = h.shape
        R, w, s = self.res, self.window, self.shift
        h = h.view(B, R, R, C)
        if s:
            h = torch.roll(h, shifts=(-s, -s), dims=(1, 2))
        with annotate("classify.attention"):
            a = self.attn(window_partition(h, w), generator, self.attention_bias())
        a = window_reverse(a, w, R, R)
        if s:
            a = torch.roll(a, shifts=(s, s), dims=(1, 2))
        return a.reshape(B, N, C)

    def _residual(self, x: torch.Tensor, h: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.drop_path > 0.0:
            h = drop_connect(h, self.drop_path, generator)
        return x + h

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.ln1(x)
        with annotate("classify.window"):
            h = self.window_half(h, generator)
        x = self._residual(x, h, generator)
        y = self.dropout(self.fc2(F.gelu(self.fc1(self.ln2(x)))), generator)
        return self._residual(x, y, generator)


class PatchMerging(nn.Module):
    """(B, R·R, C) → (B, (R/2)², 2C): each 2×2 neighbourhood's four tokens
    side by side, LayerNorm(4C), a 4C → 2C product without bias."""

    def __init__(self, width: int, res: int):
        super().__init__()
        self.res = res
        self.norm = LayerNorm(4 * width, LN_EPS)
        self.reduction = Dense(4 * width, 2 * width, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, C = x.shape
        x = x.view(B, self.res, self.res, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x.view(B, -1, 4 * C)))


class SwinStage(nn.Module):
    """A stage's blocks (``block_{i}``), the odd ones shifted, then its
    patch merging (``merge``) but in the last stage."""

    def __init__(self, plan: Dict[str, int], merge: bool, dropout: float, drop_paths):
        super().__init__()
        self.depth = plan["depth"]
        for i in range(self.depth):
            self.add_module(f"block_{i}", SwinBlock(
                plan["width"], plan["heads"], plan["res"], plan["window"],
                plan["shift"] if i % 2 else 0, dropout, drop_paths[i]))
        self.merge = PatchMerging(plan["width"], plan["res"]) if merge else None


class SwinClassifier(nn.Module):
    """Swin Transformer with a linear head on the mean token → (logits, features)."""

    def __init__(self, variant: str = "base4w7", num_classes: int = 2, image_size: int = 224,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in SWIN_CONFIGS:
            raise ValueError(f"unknown Swin variant {variant!r}; expected one of "
                             f"{sorted(SWIN_CONFIGS)}")
        cfg = SWIN_CONFIGS[variant]
        self.variant, self.image_size, self.dtype = variant, int(image_size), dtype
        self.plan = stage_plan(variant, self.image_size)
        C = cfg["embed"]
        self.patch_embed = Conv(3, C, cfg["patch"], stride=cfg["patch"],
                                padding=((0, 0), (0, 0)), bias=True)
        self.embed_norm = LayerNorm(C, LN_EPS)
        total = sum(cfg["depths"])
        rates = [DROP_PATH * i / max(total - 1, 1) for i in range(total)]
        for s, p in enumerate(self.plan):
            first = sum(cfg["depths"][:s])
            self.add_module(f"stage_{s}", SwinStage(p, s < len(self.plan) - 1, dropout,
                                                    rates[first:first + p["depth"]]))
        self.width = self.plan[-1]["width"]
        self.ln_final = LayerNorm(self.width, LN_EPS)
        self.head = Dense(self.width, num_classes)
        self.windows = self.shifted_windows = 0

    @property
    def feature_dim(self) -> int:
        return self.width

    def forward(self, images: torch.Tensor, landmarks: Optional[torch.Tensor] = None,
                backbone_start_block: int = 0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, H, W, 3) normalized NHWC at ``image_size``; landmarks unused."""
        if backbone_start_block:
            raise ValueError("a Swin has no backbone blocks to resume from")
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        # (B, N, C), patches row-major, its rows contiguous for the LayerNorm kernel.
        x = self.embed_norm(self.patch_embed(x).flatten(2).transpose(1, 2).contiguous())
        B = x.shape[0]
        for s in range(len(self.plan)):
            stage = getattr(self, f"stage_{s}")
            for i in range(stage.depth):
                block = getattr(stage, f"block_{i}")
                x = block(x, generator)
                self.windows += B * block.n_windows
                if block.shift:
                    self.shifted_windows += B * block.n_windows
            if stage.merge is not None:
                with annotate("classify.merge"):
                    x = stage.merge(x)
        feats = self.ln_final(x).mean(dim=1)
        wide = torch.promote_types(feats.dtype, torch.float32)
        return self.head(feats).to(wide), feats.to(wide)


def _tensor(t: Any) -> torch.Tensor:
    return t.detach().float().cpu() if isinstance(t, torch.Tensor) else torch.as_tensor(t).float()


# HuggingFace's names under ``swin.encoder.layers.{s}.blocks.{i}.`` → the block's
# (weight, bias).
_HF_BLOCK = {"layernorm_before": ("ln1.weight", "ln1.bias"),
             "attention.output.dense": ("attn.out_weight", "attn.out_bias"),
             "layernorm_after": ("ln2.weight", "ln2.bias"),
             "intermediate.dense": ("fc1.weight", "fc1.bias"),
             "output.dense": ("fc2.weight", "fc2.bias")}


def convert_hf_swin(state_dict: Mapping[str, Any], variant: str = "base4w7"
                    ) -> Dict[str, torch.Tensor]:
    """HuggingFace ``SwinForImageClassification`` state dict ({name: tensor
    or array}: ``swin.embeddings.*``, ``swin.encoder.layers.{s}.*``,
    ``swin.layernorm.*``, ``classifier.*``) of a ``variant`` model → the
    port's state dict. The layouts agree (linear weights (out, in), the
    patch kernel OIHW, the bias tables ((2w − 1)², heads)) but for the
    query, key and value projections, stacked into one (3C, C) product;
    the relative position indices are buffers the port builds itself."""
    sd = state_dict
    out = {"patch_embed.weight": sd["swin.embeddings.patch_embeddings.projection.weight"],
           "patch_embed.bias": sd["swin.embeddings.patch_embeddings.projection.bias"],
           "embed_norm.weight": sd["swin.embeddings.norm.weight"],
           "embed_norm.bias": sd["swin.embeddings.norm.bias"],
           "ln_final.weight": sd["swin.layernorm.weight"], "ln_final.bias": sd["swin.layernorm.bias"],
           "head.weight": sd["classifier.weight"], "head.bias": sd["classifier.bias"]}
    cfg = SWIN_CONFIGS[variant]
    for s, depth in enumerate(cfg["depths"]):
        src = f"swin.encoder.layers.{s}"
        for i in range(depth):
            hf, ours = f"{src}.blocks.{i}", f"stage_{s}.block_{i}"
            att = f"{hf}.attention.self"
            out[f"{ours}.rel_bias"] = sd[f"{att}.relative_position_bias_table"]
            for part in ("weight", "bias"):
                out[f"{ours}.attn.qkv_{part}"] = torch.cat(
                    [_tensor(sd[f"{att}.{n}.{part}"]) for n in ("query", "key", "value")])
            for name, (weight, bias) in _HF_BLOCK.items():
                out[f"{ours}.{weight}"] = sd[f"{hf}.{name}.weight"]
                out[f"{ours}.{bias}"] = sd[f"{hf}.{name}.bias"]
        if s < len(cfg["depths"]) - 1:
            out[f"stage_{s}.merge.norm.weight"] = sd[f"{src}.downsample.norm.weight"]
            out[f"stage_{s}.merge.norm.bias"] = sd[f"{src}.downsample.norm.bias"]
            out[f"stage_{s}.merge.reduction.weight"] = sd[f"{src}.downsample.reduction.weight"]
    return {k: _tensor(v) for k, v in out.items()}


def load_hf_swin(model: SwinClassifier, state_dict: Mapping[str, Any]) -> SwinClassifier:
    """A HuggingFace Swin state dict loaded into ``model`` (its variant and
    image size), strictly; returns the model."""
    model.load_state_dict(convert_hf_swin(state_dict, model.variant), strict=True)
    return model


__all__ = ["MASK", "SWIN_CONFIGS", "PatchMerging", "SwinBlock", "SwinClassifier", "SwinStage",
           "convert_hf_swin", "load_hf_swin", "relative_index", "shift_mask", "stage_plan",
           "window_partition", "window_reverse"]
