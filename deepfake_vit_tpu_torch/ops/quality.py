"""Fused, batched face-quality scoring (5 checks + weighted overall score).

- face size: min(bbox side) within [min_face_size, max_face_size]
- blur: Laplacian variance ≥ blur_threshold (reflect-101 border)
- brightness: gray mean ∈ [min_brightness, max_brightness]
- contrast: gray std ≥ min_contrast
- occlusion: mean variance of 5 landmark-centered patches (size
  min(H,W)//10, windows clipped at the image border) / 1000, clipped to
  [0,1], ≥ occlusion_threshold
- detection confidence passes through.

Variances and standard deviations are population statistics
(``correction=0``), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .image import laplacian, rgb_to_gray

DEFAULT_THRESHOLDS = dict(
    min_face_size=50.0,
    max_face_size=2000.0,
    blur_threshold=100.0,
    min_brightness=30.0,
    max_brightness=225.0,
    min_contrast=20.0,
    occlusion_threshold=0.3,
)

QUALITY_WEIGHTS = dict(
    face_size=0.15,
    blur=0.25,
    brightness=0.15,
    contrast=0.15,
    occlusion=0.15,
    detection_confidence=0.15,
)


def _patch_variance_batch(gray: torch.Tensor, landmarks: torch.Tensor,
                          region: int) -> torch.Tensor:
    """Batched patch variance: gray (B, H, W), landmarks (B, 5, 2) → (B,).

    Each window sum is R[k]·gray·C[k]ᵀ with 0-1 row/column interval
    indicators. Windows are CLIPPED at the border with the true pixel count
    in the denominator; an empty window contributes 0.
    """
    B, H, W = gray.shape
    half = region // 2
    x = landmarks[..., 0].to(torch.int32)  # truncates toward zero
    y = landmarks[..., 1].to(torch.int32)
    x1 = (x - half).clamp(0, W)
    y1 = (y - half).clamp(0, H)
    x2 = (x + half).clamp(0, W)
    y2 = (y + half).clamp(0, H)

    ii = torch.arange(H, dtype=torch.int32, device=gray.device)
    jj = torch.arange(W, dtype=torch.int32, device=gray.device)
    R = ((ii >= y1[..., None]) & (ii < y2[..., None])).to(gray.dtype)  # (B,5,H)
    Cm = ((jj >= x1[..., None]) & (jj < x2[..., None])).to(gray.dtype)  # (B,5,W)

    T1 = torch.einsum("bkh,bhw->bkw", R, gray)
    T2 = torch.einsum("bkh,bhw->bkw", R, gray * gray)
    s1 = (T1 * Cm).sum(dim=-1)  # (B, 5)
    s2 = (T2 * Cm).sum(dim=-1)

    area = (x2 - x1) * (y2 - y1)
    n = area.clamp_min(1).to(gray.dtype)
    mean = s1 / n
    var = s2 / n - mean * mean
    var = torch.where(area > 0, var, torch.zeros_like(var))
    return var.mean(dim=-1)


def quality_scores(
    images: torch.Tensor,
    landmarks: torch.Tensor,
    bboxes: torch.Tensor,
    confidences: torch.Tensor,
    thresholds: Optional[Dict[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """Raw per-metric scores + validity for a batch.

    images: (B, H, W, 3) float RGB in [0, 255]; landmarks: (B, 5, 2)
    pixels; bboxes: (B, 4) xyxy; confidences: (B,).
    """
    th = {**DEFAULT_THRESHOLDS, **(thresholds or {})}
    gray = rgb_to_gray(images.float())  # (B, H, W)
    B, H, W = gray.shape

    lap = laplacian(gray)
    blur = lap.var(dim=(1, 2), correction=0)
    brightness = gray.mean(dim=(1, 2))
    contrast = gray.std(dim=(1, 2), correction=0)

    region = max(min(H, W) // 10, 2)
    occ_var = _patch_variance_batch(gray, landmarks, region)
    occlusion = (occ_var / 1000.0).clamp_max(1.0)

    w = bboxes[:, 2] - bboxes[:, 0]
    h = bboxes[:, 3] - bboxes[:, 1]
    face_size = torch.minimum(w, h)

    valid = (
        (face_size >= th["min_face_size"])
        & (face_size <= th["max_face_size"])
        & (blur >= th["blur_threshold"])
        & (brightness >= th["min_brightness"])
        & (brightness <= th["max_brightness"])
        & (contrast >= th["min_contrast"])
        & (occlusion >= th["occlusion_threshold"])
    )
    return {
        "face_size": face_size,
        "blur": blur,
        "brightness": brightness,
        "contrast": contrast,
        "occlusion": occlusion,
        "detection_confidence": confidences,
        "is_valid": valid,
    }


def normalize_scores(scores: Dict[str, torch.Tensor],
                     thresholds: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """Per-metric [0,1] normalization."""
    th = {**DEFAULT_THRESHOLDS, **(thresholds or {})}
    fs = scores["face_size"]
    one = torch.ones_like(fs)
    return {
        "face_size": torch.where(
            fs < 100.0,
            fs / 100.0,
            torch.where(fs > 500.0, (1.0 - (fs - 500.0) / 500.0).clamp_min(0.0), one),
        ),
        "blur": (scores["blur"] / (th["blur_threshold"] * 2.0)).clamp_max(1.0),
        "brightness": (1.0 - (scores["brightness"] - 127.5).abs() / 127.5).clamp_min(0.0),
        "contrast": (scores["contrast"] / (th["min_contrast"] * 5.0)).clamp_max(1.0),
        "occlusion": scores["occlusion"],
        "detection_confidence": scores["detection_confidence"],
    }


def overall_quality(
    images: torch.Tensor,
    landmarks: torch.Tensor,
    bboxes: torch.Tensor,
    confidences: torch.Tensor,
    thresholds: Optional[Dict[str, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused overall score: (overall (B,), is_valid (B,), raw scores dict)."""
    raw = quality_scores(images, landmarks, bboxes, confidences, thresholds)
    norm = normalize_scores(raw, thresholds)
    overall = sum(QUALITY_WEIGHTS[k] * norm[k] for k in QUALITY_WEIGHTS)
    return overall, raw["is_valid"], raw
