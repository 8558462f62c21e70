"""Landmark Gaussian attention maps as one broadcast expression."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def landmark_gaussian_map(
    landmarks: torch.Tensor,
    feature_size: Tuple[int, int],
    sigma: float = 1.5,
    weights: Optional[torch.Tensor] = None,
    input_size: float = 224.0,
    normalize: str = "global_max",
    clip_range: Optional[Tuple[float, float]] = (0.1, 1.0),
) -> torch.Tensor:
    """Sum-of-Gaussians attention map from 5-point landmarks.

    landmarks: (B, 5, 2) (x, y) in ``input_size`` pixel coords; returns a
    (B, 1, H, W) map (NCHW-broadcastable). ``normalize``: 'global_max'
    (max over the whole batch), 'per_sample' or 'none'.
    """
    H, W = feature_size
    dtype = landmarks.dtype if landmarks.is_floating_point() else torch.float32
    landmarks = landmarks.to(dtype)
    dev = landmarks.device

    scale = torch.tensor([W / input_size, H / input_size], dtype=dtype, device=dev)
    lm = landmarks * scale  # (B, 5, 2) in feature-map coords

    ys = torch.arange(H, dtype=dtype, device=dev)
    xs = torch.arange(W, dtype=dtype, device=dev)
    dy = ys[None, None, :, None] - lm[:, :, 1][:, :, None, None]
    dx = xs[None, None, None, :] - lm[:, :, 0][:, :, None, None]
    dist_sq = dx * dx + dy * dy
    gauss = torch.exp(-dist_sq / (2.0 * sigma * sigma))

    if weights is not None:
        gauss = gauss * weights.to(dtype)[None, :, None, None]
    amap = gauss.sum(dim=1, keepdim=True)  # (B, 1, H, W)

    if normalize == "global_max":
        amap = amap / (amap.max() + 1e-8)
    elif normalize == "per_sample":
        amap = amap / (amap.amax(dim=(1, 2, 3), keepdim=True) + 1e-8)
    elif normalize != "none":
        raise ValueError(f"unknown normalize mode: {normalize}")

    if clip_range is not None:
        amap = amap.clamp(clip_range[0], clip_range[1])
    return amap
