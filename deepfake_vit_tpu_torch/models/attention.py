"""Hybrid attention (landmark + channel-SE + spatial-CBAM) on NCHW maps.

- LandmarkAttention: σ=1.5 Gaussian bumps at 5 landmarks scaled from a
  FIXED 224² input frame to feature-map coords (the JAX package keeps 224
  even for 192² faces; reproduced here, not fixed), learnable per-landmark
  weights (init ones), batch-global max normalization, clamp [0.1, 1.0].
- ChannelAttention: avg+max global pooling through a shared bias-free
  2-layer MLP (reduction 16), summed then sigmoid.
- SpatialAttention: channel-mean ‖ channel-max → 7×7 bias-free conv → sigmoid.
- HybridAttention: landmark → channel → spatial, each toggleable.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gaussian import landmark_gaussian_map
from .layers import Conv, Dense, _as_tensor, _copy_checked, _numpy


class LandmarkAttention(nn.Module):
    def __init__(self, sigma: float = 1.5, input_size: float = 224.0):
        super().__init__()
        self.sigma, self.input_size = sigma, input_size
        self.attention_weights = nn.Parameter(torch.ones(5))

    def forward(self, feature_maps: torch.Tensor, landmarks: torch.Tensor) -> torch.Tensor:
        """feature_maps: (B, C, H, W); landmarks: (B, 5, 2) in input-px coords."""
        H, W = feature_maps.shape[2], feature_maps.shape[3]
        amap = landmark_gaussian_map(
            landmarks.to(torch.promote_types(feature_maps.dtype, torch.float32)), (H, W), sigma=self.sigma, weights=self.attention_weights,
            input_size=self.input_size, normalize="global_max", clip_range=(0.1, 1.0),
        )  # (B, 1, H, W)
        return feature_maps * amap.to(feature_maps.dtype)

    def load_flax(self, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        _copy_checked(self.attention_weights, _as_tensor(params["attention_weights"]),
                      "LandmarkAttention.attention_weights")

    def export_flax(self):
        return {"attention_weights": _numpy(self.attention_weights)}, {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.attention_weights)


class ChannelAttention(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = channels // reduction
        self.fc1 = Dense(channels, hidden, bias=False)
        self.fc2 = Dense(hidden, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        shared = lambda v: self.fc2(F.relu(self.fc1(v)))  # noqa: E731 — one shared MLP
        scale = torch.sigmoid(shared(avg) + shared(mx))  # (B, C)
        return x * scale[:, :, None, None].to(x.dtype)


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = Conv(2, 1, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=1, keepdim=True)
        mx = x.amax(dim=1, keepdim=True)
        attn = self.conv(torch.cat([avg, mx], dim=1))  # (B, 1, H, W)
        return x * torch.sigmoid(attn).to(x.dtype)


class HybridAttention(nn.Module):
    def __init__(self, channels: int, use_landmark: bool = True, use_spatial: bool = True,
                 use_channel: bool = True):
        super().__init__()
        self.use_landmark, self.use_channel, self.use_spatial = use_landmark, use_channel, use_spatial
        if use_landmark:
            self.landmark_attn = LandmarkAttention()
        if use_channel:
            self.channel_attn = ChannelAttention(channels)
        if use_spatial:
            self.spatial_attn = SpatialAttention()

    def forward(self, feature_maps: torch.Tensor,
                landmarks: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = feature_maps
        if self.use_landmark and landmarks is not None:
            x = self.landmark_attn(x, landmarks)
        if self.use_channel:
            x = self.channel_attn(x)
        if self.use_spatial:
            x = self.spatial_attn(x)
        return x
