"""SCRFD anchor-center generation and distance/keypoint decode.

Strides {8, 16, 32} with 2 anchors per location, centers flattened
row-major then by anchor — the layout the detector head emits.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2


def anchor_centers(input_size: Tuple[int, int], strides: Sequence[int] = STRIDES,
                   num_anchors: int = NUM_ANCHORS) -> Dict[int, np.ndarray]:
    """Per-stride anchor center grids: {stride: (H/s * W/s * A, 2)} in pixels."""
    H, W = input_size
    out = {}
    for s in strides:
        h, w = H // s, W // s
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        centers = np.stack([xs, ys], axis=-1).astype(np.float32) * s
        out[s] = np.repeat(centers.reshape(-1, 2), num_anchors, axis=0)
    return out


def all_anchor_centers(input_size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated centers across strides, plus per-row stride array."""
    per = anchor_centers(tuple(input_size))
    centers = np.concatenate([per[s] for s in STRIDES], axis=0)
    strides = np.concatenate(
        [np.full((per[s].shape[0],), s, np.float32) for s in STRIDES]
    )
    return centers, strides


def decode_boxes(centers: torch.Tensor, strides: torch.Tensor,
                 dist: torch.Tensor) -> torch.Tensor:
    """Distance decode: dist (..., N, 4) = (l, t, r, b) in stride units → xyxy."""
    d = dist * strides[..., None]
    x1 = centers[..., 0] - d[..., 0]
    y1 = centers[..., 1] - d[..., 1]
    x2 = centers[..., 0] + d[..., 2]
    y2 = centers[..., 1] + d[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def decode_landmarks(centers: torch.Tensor, strides: torch.Tensor,
                     kps: torch.Tensor) -> torch.Tensor:
    """Keypoint decode: kps (..., N, 10) offsets in stride units → (..., N, 5, 2)."""
    k = kps.reshape(kps.shape[:-1] + (5, 2)) * strides[..., None, None]
    return k + centers[..., None, :]
