"""Feature extractor + full detection model.

- ``DeepfakeFeatureExtractor``: backbone feature maps → HybridAttention →
  global average pool → dropout → (B, feature_dim) features.
- ``DeepfakeDetectionModel``: extractor + MLP head (Dense → BatchNorm
  (momentum 0.9, eps 1e-5) → ReLU → Dropout per hidden dim, final Dense →
  num_classes); ``forward`` returns the ``(logits, features)`` contract,
  both float32.

In train mode (``module.train()``) the dropouts, the backbone's
drop-connect and the BatchNorms act as flax's ``train=True`` does; the
masks draw from the ``generator`` passed to ``forward``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import HybridAttention
from .efficientnet import EfficientNetBackbone, feature_dim
from .layers import BatchNorm, Dense, Dropout


class DeepfakeFeatureExtractor(nn.Module):
    def __init__(self, variant: str = "b4", use_attention: bool = True, use_landmark: bool = True,
                 use_spatial: bool = True, use_channel: bool = True,
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.4,
                 freeze_bn: bool = False):
        super().__init__()
        self.variant, self.use_attention = variant, use_attention
        self.backbone = EfficientNetBackbone(variant, dtype=dtype, dropout_rate=dropout_rate,
                                             freeze_bn=freeze_bn)
        self.dropout = Dropout(dropout_rate)
        if use_attention:
            self.attention = HybridAttention(feature_dim(variant), use_landmark=use_landmark,
                                             use_spatial=use_spatial, use_channel=use_channel)

    @property
    def feature_dim(self) -> int:
        return feature_dim(self.variant)

    def forward(self, images: torch.Tensor, landmarks: Optional[torch.Tensor] = None,
                backbone_start_block: int = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images: (B, H, W, 3) normalized NHWC; landmarks: (B, 5, 2)."""
        maps = self.backbone(images, start_block=backbone_start_block, generator=generator)
        if self.use_attention:
            maps = self.attention(maps, landmarks)
        return self.dropout(maps.mean(dim=(2, 3)), generator)


class _ClassifierBlock(nn.Module):
    def __init__(self, in_features: int, features: int, dropout_rate: float = 0.4):
        super().__init__()
        self.dense = Dense(in_features, features)
        self.bn = BatchNorm(features, 1e-5, momentum=0.9)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.dropout(F.relu(self.bn(self.dense(x))), generator)


class DeepfakeDetectionModel(nn.Module):
    """Full model: features + MLP head; returns (logits, features)."""

    def __init__(self, num_classes: int = 2, variant: str = "b4",
                 classifier_hidden_dims: Sequence[int] = (512, 128, 32),
                 use_attention: bool = True, use_landmark: bool = True, use_spatial: bool = True,
                 use_channel: bool = True, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.4, feature_dropout_rate: float = 0.4,
                 freeze_bn: bool = False):
        super().__init__()
        self.variant = variant
        self.feature_extractor = DeepfakeFeatureExtractor(
            variant, use_attention, use_landmark, use_spatial, use_channel, dtype=dtype,
            dropout_rate=feature_dropout_rate, freeze_bn=freeze_bn)
        cin = feature_dim(variant)
        self.n_hidden = len(classifier_hidden_dims)
        for i, hidden in enumerate(classifier_hidden_dims):
            self.add_module(f"head_{i}", _ClassifierBlock(cin, hidden, dropout_rate))
            cin = hidden
        self.final = Dense(cin, num_classes)

    def forward(self, images: torch.Tensor, landmarks: Optional[torch.Tensor] = None,
                backbone_start_block: int = 0,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        features = self.feature_extractor(images, landmarks, backbone_start_block, generator)
        x = features
        for i in range(self.n_hidden):
            x = getattr(self, f"head_{i}")(x, generator)
        wide = torch.promote_types(features.dtype, torch.float32)
        return self.final(x).to(wide), features.to(wide)


def create_model_from_config(model_cfg: Dict[str, Any],
                             dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build the classifier from the model config's 'model' block.

    ``type: efficientnet`` (the default) builds a ``DeepfakeDetectionModel``:
    the head's ``classifier.dropout_rate``, the features'
    ``feature_extractor.dropout_rate`` and ``freeze_bn`` as the JAX
    function reads them. ``type: vit`` builds the fallback
    ``ViTClassifier`` from ``feature_extractor.{variant, image_size,
    dropout_rate}`` (defaults base16, 224, 0.0) and
    ``classifier.num_classes``. Both return ``(logits, features)``.
    Serving objects put the model in eval mode; a trainer calls
    ``train()``."""
    kind = model_cfg.get("type", "efficientnet")
    fe = model_cfg.get("feature_extractor", {})
    clf = model_cfg.get("classifier", {})
    if kind == "vit":
        from .vit import ViTClassifier

        return ViTClassifier(variant=fe.get("variant", "base16"),
                             num_classes=clf.get("num_classes", 2),
                             image_size=int(fe.get("image_size", 224)),
                             dropout=float(fe.get("dropout_rate", 0.0)), dtype=dtype)
    if kind != "efficientnet":
        raise ValueError(f"unknown model type {kind!r}; expected 'efficientnet' or 'vit'")
    attn = fe.get("attention_config", {}) or {}
    return DeepfakeDetectionModel(
        num_classes=clf.get("num_classes", 2),
        variant=fe.get("variant", "b4"),
        classifier_hidden_dims=tuple(clf.get("hidden_dims", [512, 128, 32])),
        use_attention=fe.get("use_attention", True),
        use_landmark=attn.get("use_landmark", True),
        use_spatial=attn.get("use_spatial", True),
        use_channel=attn.get("use_channel", True),
        dtype=dtype,
        dropout_rate=clf.get("dropout_rate", 0.4),
        feature_dropout_rate=fe.get("dropout_rate", 0.4),
        freeze_bn=fe.get("freeze_bn", False),
    )
