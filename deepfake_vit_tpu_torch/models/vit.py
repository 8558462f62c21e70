"""Vision Transformer classifier: the fallback model family.

Counterpart of the JAX package's ``models/vit.py`` (the reference's
fallback submission stack pairs a HuggingFace ``ViTForImageClassification``
with the dlib HOG detector): a strided patch convolution, a CLS token and
learned position embeddings, pre-LayerNorm encoder blocks (attention, then
an MLP with exact GELU), a final LayerNorm and a linear head on the CLS
vector. The submodules carry the flax names (``patch_embed``,
``block_{i}.{ln1,attn,ln2,fc1,fc2}``, ``ln_final``, ``head``), and
``cls_token`` and ``pos_embed`` are parameters of the classifier itself
(``FLAX_PARAMS``), so ``models/bridge.py`` loads and exports the JAX tree
as it is.

``forward(images, landmarks=None, backbone_start_block=0, generator=None)``
returns ``(logits, features)`` like ``DeepfakeDetectionModel``: both in
float32 (float64 for a float64 model), ``features`` the CLS vector after
the final LayerNorm. Landmarks are accepted and unused. In train mode
(``module.train()``) the dropouts after the embedding, in the attention
weights and after each MLP draw their masks from ``generator``.

``convert_hf_vit`` turns a HuggingFace state dict into the JAX function's
flax tree; ``load_hf_vit`` loads one into a ``ViTClassifier``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import annotate
from .bridge import load_flax_variables
from .layers import Conv, Dense, Dropout, LayerNorm, MultiHeadDotProductAttention

VIT_CONFIGS = {
    "base16": dict(patch=16, width=768, depth=12, heads=12, mlp=3072),
    "small16": dict(patch=16, width=384, depth=12, heads=6, mlp=1536),
    "tiny16": dict(patch=16, width=192, depth=12, heads=3, mlp=768),
}
LN_EPS = 1e-12


class EncoderBlock(nn.Module):
    """ln1 → attention → residual → ln2 → fc1 → exact GELU → fc2 → dropout
    → residual (no dropout after the attention's output projection)."""

    def __init__(self, width: int, heads: int, mlp: int, dropout: float):
        super().__init__()
        self.ln1 = LayerNorm(width, LN_EPS)
        self.attn = MultiHeadDotProductAttention(width, heads, dropout)
        self.ln2 = LayerNorm(width, LN_EPS)
        self.fc1 = Dense(width, mlp)
        self.fc2 = Dense(mlp, width)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.ln1(x)
        with annotate("classify.attention"):
            h = self.attn(h, generator)
        x = x + h
        y = self.fc2(F.gelu(self.fc1(self.ln2(x))))
        return x + self.dropout(y, generator)


class ViTClassifier(nn.Module):
    """ViT with a CLS token and a linear head → (logits, CLS features)."""

    FLAX_PARAMS = ("cls_token", "pos_embed")

    def __init__(self, variant: str = "base16", num_classes: int = 2, image_size: int = 224,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in VIT_CONFIGS:
            raise ValueError(f"unknown ViT variant {variant!r}; expected one of "
                             f"{sorted(VIT_CONFIGS)}")
        cfg = VIT_CONFIGS[variant]
        P, W = cfg["patch"], cfg["width"]
        self.variant, self.image_size, self.dtype = variant, int(image_size), dtype
        self.patch, self.width, self.depth = P, W, cfg["depth"]
        self.n_patches = (self.image_size // P) ** 2
        self.patch_embed = Conv(3, W, P, stride=P, padding=((0, 0), (0, 0)), bias=True)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, W))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.n_patches + 1, W))
        self.dropout = Dropout(dropout)
        for i in range(self.depth):
            self.add_module(f"block_{i}", EncoderBlock(W, cfg["heads"], cfg["mlp"], dropout))
        self.ln_final = LayerNorm(W, LN_EPS)
        self.head = Dense(W, num_classes)

    @property
    def feature_dim(self) -> int:
        return self.width

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers of the classifier's own parameters:
        ``cls_token`` zeros, ``pos_embed`` N(0, 0.02)."""
        nn.init.zeros_(self.cls_token)
        with torch.no_grad():
            self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape, generator=generator))

    def forward(self, images: torch.Tensor, landmarks: Optional[torch.Tensor] = None,
                backbone_start_block: int = 0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, H, W, 3) normalized NHWC at ``image_size``; landmarks unused."""
        if backbone_start_block:
            raise ValueError("a ViT has no backbone blocks to resume from")
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, N, W), patches row-major
        B = x.shape[0]
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, self.width), x], dim=1)
        x = self.dropout(x + self.pos_embed.to(x.dtype), generator)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, generator)
        cls = self.ln_final(x)[:, 0]
        wide = torch.promote_types(cls.dtype, torch.float32)
        return self.head(cls).to(wide), cls.to(wide)

    def predict(self, images: torch.Tensor, landmarks: Optional[torch.Tensor] = None,
                return_probs: bool = True) -> torch.Tensor:
        logits, _ = self(images, landmarks)
        return torch.softmax(logits, dim=-1) if return_probs else logits


def _npy(t: Any) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def convert_hf_vit(state_dict: Mapping[str, Any], variant: str = "base16") -> Dict[str, Any]:
    """HuggingFace ``ViTForImageClassification`` state dict ({name: tensor
    or array}, HF's names ``vit.embeddings.*``, ``vit.encoder.layer.N.*``,
    ``classifier.*``) → the flax tree ``{"params": ...}`` the JAX function
    returns: conv kernels OIHW → HWIO, linear weights (out, in) → (in, out),
    the attention's projections split into heads."""
    cfg = VIT_CONFIGS[variant]
    W, H = cfg["width"], cfg["heads"]
    hd = W // H
    sd = state_dict
    p: Dict[str, Any] = {
        "patch_embed": {
            "kernel": _npy(sd["vit.embeddings.patch_embeddings.projection.weight"])
            .transpose(2, 3, 1, 0),
            "bias": _npy(sd["vit.embeddings.patch_embeddings.projection.bias"]),
        },
        "cls_token": _npy(sd["vit.embeddings.cls_token"]),
        "pos_embed": _npy(sd["vit.embeddings.position_embeddings"]),
    }

    def ln(key):
        return {"scale": _npy(sd[f"{key}.weight"]), "bias": _npy(sd[f"{key}.bias"])}

    def dense(key):
        return {"kernel": _npy(sd[f"{key}.weight"]).T, "bias": _npy(sd[f"{key}.bias"])}

    for i in range(cfg["depth"]):
        src = f"vit.encoder.layer.{i}"

        def qkv(name):
            d = dense(f"{src}.attention.attention.{name}")
            return {"kernel": d["kernel"].reshape(W, H, hd), "bias": d["bias"].reshape(H, hd)}

        out = dense(f"{src}.attention.output.dense")
        p[f"block_{i}"] = {
            "ln1": ln(f"{src}.layernorm_before"),
            "attn": {"query": qkv("query"), "key": qkv("key"), "value": qkv("value"),
                     "out": {"kernel": out["kernel"].reshape(H, hd, W), "bias": out["bias"]}},
            "ln2": ln(f"{src}.layernorm_after"),
            "fc1": dense(f"{src}.intermediate.dense"),
            "fc2": dense(f"{src}.output.dense"),
        }
    p["ln_final"] = ln("vit.layernorm")
    p["head"] = dense("classifier")
    return {"params": p}


def load_hf_vit(model: ViTClassifier, state_dict: Mapping[str, Any]) -> ViTClassifier:
    """A HuggingFace ViT state dict loaded into ``model`` (its variant's
    layout), strictly; returns the model."""
    return load_flax_variables(model, convert_hf_vit(state_dict, model.variant))


__all__ = ["EncoderBlock", "VIT_CONFIGS", "ViTClassifier", "convert_hf_vit", "load_hf_vit"]
