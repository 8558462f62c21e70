"""Batched image primitives (grayscale, Laplacian, ImageNet statistics)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# ITU-R BT.601 luma weights — cv2.COLOR_RGB2GRAY semantics.
_LUMA = (0.299, 0.587, 0.114)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float → (..., H, W) luma, cv2 RGB2GRAY weights."""
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def laplacian(gray: torch.Tensor) -> torch.Tensor:
    """3×3 Laplacian with reflect-101 border (cv2.Laplacian defaults).

    gray: (B, H, W) → (B, H, W). ``F.pad(mode="reflect")`` is reflect-101.
    """
    x = F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    center = x[:, 1:-1, 1:-1]
    up = x[:, :-2, 1:-1]
    down = x[:, 2:, 1:-1]
    left = x[:, 1:-1, :-2]
    right = x[:, 1:-1, 2:]
    return up + down + left + right - 4.0 * center


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """float [0,1] RGB (..., 3) → ImageNet-normalized, float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (images - mean) / std
