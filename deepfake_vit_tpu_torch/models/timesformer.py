"""TimeSformer clip classifier: divided space-time attention over the
frames of one face track.

Bertasius, Wang and Torresani, "Is Space-Time Attention All You Need for
Video Understanding?" (ICML 2021, arXiv:2102.05095), in the layout of
``facebook/timesformer-base-finetuned-k400``: 8 frames of 224², patch 16,
width 768, 12 blocks of 12 heads, MLP 3,072, exact GELU, LayerNorm eps
1e-6, QKV bias. The JAX package has no such family: this one is the port's
own, with no flax tree behind it.

For a clip of T frames and N patches a frame the tokens are one CLS vector
c and z[t, n] = PatchConv(frame t)[n] + pos[1 + n] + time[t]; c = cls +
pos[0]. Each block:

- temporal half, one sequence a patch over its T frames:
  z ← z + Dense_td(Attn_t(LN_t(z[:, n])));
- spatial half, one sequence a frame over [c; z[t]]:
  a_t = Attn_s(LN_1([c; z[t]])), c ← c + mean_t a_t[0], z[t] ← z[t] + a_t[1:];
- MLP half on all 1 + T·N tokens: x ← x + fc2(GELU(fc1(LN_2(x)))).

The verdict is ``head(LN_f(c))``, one a clip. Tokens live frame-major,
``(C, 1 + T·N, W)``: the CLS, then frame 0's N patches, frame 1's, and so
on, so the spatial half reads each frame's patches as they lie and the
temporal half moves them to patch-major sequences and back.

``forward(images, landmarks=None, backbone_start_block=0, generator=None)``
takes (C·T, H, W, 3) normalized NHWC faces, T consecutive faces to a clip,
and returns ``(logits (C, classes), features (C, W))`` in float32 (float64
for a float64 model), ``features`` the CLS vector after the final
LayerNorm. Landmarks are accepted and unused. While ``torch.profiler``
records, each block's temporal half is a ``classify.temporal`` range and
its spatial half a ``classify.spatial`` range holding the attention's
``classify.attention``.

``convert_hf_timesformer`` renames a HuggingFace
``TimesformerForVideoClassification`` state dict to the port's names;
``load_hf_timesformer`` loads one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import annotate
from .layers import Conv, Dense, Dropout, LayerNorm, MultiHeadDotProductAttention
from .vit import VIT_CONFIGS

TIMESFORMER_CONFIGS = {
    "base16": VIT_CONFIGS["base16"],
    # The CPU tests' size: every kind of layer, a few thousand parameters a block.
    "tiny8": dict(patch=8, width=64, depth=2, heads=2, mlp=256),
}
LN_EPS = 1e-6


class DividedSpaceTimeBlock(nn.Module):
    """Temporal half, spatial half, MLP half on frame-major tokens
    (C, 1 + T·N, W); dropout after the MLP and in the attention weights,
    as in the ViT's ``EncoderBlock``."""

    def __init__(self, width: int, heads: int, mlp: int, num_frames: int, n_patches: int,
                 dropout: float):
        super().__init__()
        self.num_frames, self.n_patches = num_frames, n_patches
        self.ln_t = LayerNorm(width, LN_EPS)
        self.attn_t = MultiHeadDotProductAttention(width, heads, dropout)
        self.dense_t = Dense(width, width)
        self.ln1 = LayerNorm(width, LN_EPS)
        self.attn = MultiHeadDotProductAttention(width, heads, dropout)
        self.ln2 = LayerNorm(width, LN_EPS)
        self.fc1 = Dense(width, mlp)
        self.fc2 = Dense(mlp, width)
        self.dropout = Dropout(dropout)

    def temporal(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z ← z + Dense_td(Attn_t(LN_t(z))) over each patch's T frames."""
        C, _, W = x.shape
        T, N = self.num_frames, self.n_patches
        z = x[:, 1:].reshape(C, T, N, W).transpose(1, 2).reshape(C * N, T, W)
        h = self.dense_t(self.attn_t(self.ln_t(z), generator))
        h = h.reshape(C, N, T, W).transpose(1, 2).reshape(C, T * N, W)
        return torch.cat([x[:, :1], x[:, 1:] + h], dim=1)

    def spatial(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Attention over each frame's [c; z[t]]; the CLS gains the mean of
        its T outputs, each frame's patches their own."""
        C, _, W = x.shape
        T, N = self.num_frames, self.n_patches
        frames = torch.cat([x[:, None, :1].expand(C, T, 1, W), x[:, 1:].reshape(C, T, N, W)],
                           dim=2).reshape(C * T, 1 + N, W)
        h = self.ln1(frames)
        with annotate("classify.attention"):
            a = self.attn(h, generator).reshape(C, T, 1 + N, W)
        return x + torch.cat([a[:, :, 0].mean(dim=1, keepdim=True),
                              a[:, :, 1:].reshape(C, T * N, W)], dim=1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with annotate("classify.temporal"):
            x = self.temporal(x, generator)
        with annotate("classify.spatial"):
            x = self.spatial(x, generator)
        y = self.fc2(F.gelu(self.fc1(self.ln2(x))))
        return x + self.dropout(y, generator)


class TimeSformerClassifier(nn.Module):
    """TimeSformer with divided space-time attention → (clip logits, CLS features)."""

    def __init__(self, variant: str = "base16", num_frames: int = 8, image_size: int = 224,
                 num_classes: int = 2, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in TIMESFORMER_CONFIGS:
            raise ValueError(f"unknown TimeSformer variant {variant!r}; expected one of "
                             f"{sorted(TIMESFORMER_CONFIGS)}")
        cfg = TIMESFORMER_CONFIGS[variant]
        P, W = cfg["patch"], cfg["width"]
        if num_frames < 1 or image_size % P:
            raise ValueError(f"a TimeSformer takes clips of at least one frame of a multiple "
                             f"of {P} pixels, not {num_frames} frames of {image_size}")
        self.variant, self.image_size, self.dtype = variant, int(image_size), dtype
        self.num_frames, self.patch, self.width, self.depth = int(num_frames), P, W, cfg["depth"]
        self.n_patches = (self.image_size // P) ** 2
        self.patch_embed = Conv(3, W, P, stride=P, padding=((0, 0), (0, 0)), bias=True)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, W))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.n_patches + 1, W))
        self.time_embed = nn.Parameter(torch.zeros(1, self.num_frames, W))
        self.dropout = Dropout(dropout)
        for i in range(self.depth):
            self.add_module(f"block_{i}", DividedSpaceTimeBlock(
                W, cfg["heads"], cfg["mlp"], self.num_frames, self.n_patches, dropout))
        self.ln_final = LayerNorm(W, LN_EPS)
        self.head = Dense(W, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The classifier's own parameters: ``cls_token`` zeros,
        ``pos_embed`` and ``time_embed`` N(0, 0.02)."""
        nn.init.zeros_(self.cls_token)
        with torch.no_grad():
            for p in (self.pos_embed, self.time_embed):
                p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    def forward(self, images: torch.Tensor, landmarks: Optional[torch.Tensor] = None,
                backbone_start_block: int = 0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (C·T, H, W, 3) normalized NHWC at ``image_size``, the T
        frames of each clip consecutive; landmarks unused."""
        if backbone_start_block:
            raise ValueError("a TimeSformer has no backbone blocks to resume from")
        T, N, W = self.num_frames, self.n_patches, self.width
        if images.shape[0] % T:
            raise ValueError(f"{images.shape[0]} faces do not make clips of {T} frames")
        C = images.shape[0] // T
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (C·T, N, W), patches row-major
        z = (x + self.pos_embed[:, 1:].to(x.dtype)).reshape(C, T, N, W)
        z = z + self.time_embed.to(x.dtype)[:, :, None]
        cls = (self.cls_token + self.pos_embed[:, :1]).to(x.dtype).expand(C, 1, W)
        x = self.dropout(torch.cat([cls, z.reshape(C, T * N, W)], dim=1), generator)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, generator)
        cls = self.ln_final(x[:, 0])
        wide = torch.promote_types(cls.dtype, torch.float32)
        return self.head(cls).to(wide), cls.to(wide)


# HuggingFace's names under ``timesformer.encoder.layer.{i}.`` → the block's.
_HF_BLOCK = {
    "temporal_layernorm": "ln_t",
    "temporal_attention.attention.qkv": ("attn_t.qkv_weight", "attn_t.qkv_bias"),
    "temporal_attention.output.dense": ("attn_t.out_weight", "attn_t.out_bias"),
    "temporal_dense": "dense_t",
    "layernorm_before": "ln1",
    "attention.attention.qkv": ("attn.qkv_weight", "attn.qkv_bias"),
    "attention.output.dense": ("attn.out_weight", "attn.out_bias"),
    "layernorm_after": "ln2",
    "intermediate.dense": "fc1",
    "output.dense": "fc2",
}


def _tensor(t: Any) -> torch.Tensor:
    return t.detach().float().cpu() if isinstance(t, torch.Tensor) else torch.as_tensor(t).float()


def convert_hf_timesformer(state_dict: Mapping[str, Any], depth: int) -> Dict[str, torch.Tensor]:
    """HuggingFace ``TimesformerForVideoClassification`` state dict
    ({name: tensor or array}: ``timesformer.embeddings.*``,
    ``timesformer.encoder.layer.{i}.*``, ``timesformer.layernorm.*``,
    ``classifier.*``) of a ``depth``-block model → the port's state dict.
    The layouts agree (linear weights (out, in), the QKV projection's rows
    ordered (3, heads, head_dim), the patch kernel OIHW): only the names
    change."""
    sd = state_dict
    out = {"cls_token": sd["timesformer.embeddings.cls_token"],
           "pos_embed": sd["timesformer.embeddings.position_embeddings"],
           "time_embed": sd["timesformer.embeddings.time_embeddings"],
           "patch_embed.weight": sd["timesformer.embeddings.patch_embeddings.projection.weight"],
           "patch_embed.bias": sd["timesformer.embeddings.patch_embeddings.projection.bias"],
           "ln_final.weight": sd["timesformer.layernorm.weight"],
           "ln_final.bias": sd["timesformer.layernorm.bias"],
           "head.weight": sd["classifier.weight"], "head.bias": sd["classifier.bias"]}
    for i in range(depth):
        src = f"timesformer.encoder.layer.{i}"
        for hf, ours in _HF_BLOCK.items():
            weight, bias = ours if isinstance(ours, tuple) else (f"{ours}.weight", f"{ours}.bias")
            out[f"block_{i}.{weight}"] = sd[f"{src}.{hf}.weight"]
            out[f"block_{i}.{bias}"] = sd[f"{src}.{hf}.bias"]
    return {k: _tensor(v) for k, v in out.items()}


def load_hf_timesformer(model: TimeSformerClassifier,
                        state_dict: Mapping[str, Any]) -> TimeSformerClassifier:
    """A HuggingFace TimeSformer state dict loaded into ``model`` (its
    variant, frame count and image size), strictly; returns the model."""
    model.load_state_dict(convert_hf_timesformer(state_dict, model.depth), strict=True)
    return model


__all__ = ["DividedSpaceTimeBlock", "TIMESFORMER_CONFIGS", "TimeSformerClassifier",
           "convert_hf_timesformer", "load_hf_timesformer"]
