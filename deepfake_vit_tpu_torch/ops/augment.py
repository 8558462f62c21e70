"""On-device data augmentation of a training batch: flip, rotation and
color jitter.

Counterpart of the JAX package's ``ops/augment.py``. Each augmentation is
split into its random draw (from an explicit ``torch.Generator`` on the
batch's device) and a deterministic apply, so that the draws can be fed in
from elsewhere:

- horizontal flip (probability 0.5 a sample): image mirror, landmark x
  reflected to W − 1 − x and left/right identities swapped (eyes, mouth
  corners);
- rotation by θ ~ U(−max, max) degrees about the image center through
  ``ops/warp.py::warp_affine_auto`` (the legacy-tap warp kernel on a CUDA
  device, its plain version on the CPU; bilinear, border 0), landmarks
  moved by the same matrix;
- color jitter: per-sample brightness (added) and contrast (scaled about
  the image mean) in normalized units.

Landmarks are (x, y) pixels in the order [left_eye, right_eye, nose,
left_mouth, right_mouth]. The warp kernel has no backward, and the batch
needs none: the augmentation runs without autograd.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .umeyama import transform_points
from .warp import warp_affine_auto

_FLIP_PERM = (1, 0, 2, 4, 3)  # swap L/R eye and mouth


def _uniform(shape, low: float, high: float, generator: torch.Generator,
             device: torch.device) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=generator, device=device)


def draw_flip(batch: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """(B,) bool: which samples flip."""
    return torch.rand(batch, generator=generator, device=device) < 0.5


def flip(images: torch.Tensor, landmarks: Optional[torch.Tensor], mask: torch.Tensor):
    """Mirror the samples where ``mask`` (B,) holds; images (B, H, W, C)."""
    W = images.shape[2]
    images = torch.where(mask[:, None, None, None], images.flip(2), images)
    if landmarks is not None:
        lm_f = landmarks.clone()
        lm_f[:, :, 0] = W - 1.0 - landmarks[:, :, 0]
        lm_f = lm_f[:, list(_FLIP_PERM)]
        landmarks = torch.where(mask[:, None, None], lm_f, landmarks)
    return images, landmarks


def random_flip(images: torch.Tensor, landmarks: Optional[torch.Tensor],
                generator: torch.Generator):
    return flip(images, landmarks, draw_flip(images.shape[0], generator, images.device))


def draw_rotation(batch: int, max_degrees: float, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """(B,) angles in radians, uniform in ±``max_degrees``."""
    return _uniform(batch, -max_degrees, max_degrees, generator, device) * (math.pi / 180.0)


def rotation_matrices(theta: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, 2, 3) src→dst rotations by ``theta`` about the center of an
    (H, W) image."""
    H, W = size
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    tx = cx - cos * cx + sin * cy
    ty = cy - sin * cx - cos * cy
    return torch.stack([torch.stack([cos, -sin, tx], -1), torch.stack([sin, cos, ty], -1)], 1)


def rotate(images: torch.Tensor, landmarks: Optional[torch.Tensor], theta: torch.Tensor):
    """Rotate each sample by ``theta`` (B,) radians about its center."""
    H, W = images.shape[1], images.shape[2]
    A = rotation_matrices(theta.float(), (H, W))
    images = warp_affine_auto(images, A, (H, W))
    if landmarks is not None:
        landmarks = transform_points(A, landmarks)
    return images, landmarks


def random_rotation(images: torch.Tensor, landmarks: Optional[torch.Tensor],
                    generator: torch.Generator, max_degrees: float = 5.0):
    theta = draw_rotation(images.shape[0], max_degrees, generator, images.device)
    return rotate(images, landmarks, theta)


def draw_jitter(batch: int, strength: float, generator: torch.Generator, device: torch.device):
    """(brightness, contrast), each (B, 1, 1, 1): brightness ~ U(±s),
    contrast ~ 1 + U(±s)."""
    brightness = _uniform((batch, 1, 1, 1), -strength, strength, generator, device)
    contrast = 1.0 + _uniform((batch, 1, 1, 1), -strength, strength, generator, device)
    return brightness, contrast


def jitter(images: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor) -> torch.Tensor:
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return (images - mean) * contrast + mean + brightness


def color_jitter(images: torch.Tensor, generator: torch.Generator,
                 strength: float = 0.1) -> torch.Tensor:
    return jitter(images, *draw_jitter(images.shape[0], strength, generator, images.device))


def make_augment_fn(aug_cfg: Optional[Dict[str, Any]]) -> Optional[Callable]:
    """``augment(batch, generator) -> batch`` from the config's
    ``data.augmentation`` block (``enabled``, default False;
    ``random_flip`` bool, ``random_rotation`` degrees, ``color_jitter``
    strength), or None when it is not enabled. Flip, then rotation, then
    jitter, each drawn from ``generator`` in that order."""
    cfg = aug_cfg or {}
    if not cfg.get("enabled", False):
        return None
    use_flip = bool(cfg.get("random_flip", True))
    rot_deg = float(cfg.get("random_rotation", 0) or 0)
    strength = float(cfg.get("color_jitter", 0) or 0)

    @torch.no_grad()
    def augment(batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
        images, landmarks = batch["image"], batch.get("landmarks")
        if use_flip:
            images, landmarks = random_flip(images, landmarks, generator)
        if rot_deg > 0:
            images, landmarks = random_rotation(images, landmarks, generator, rot_deg)
        if strength > 0:
            images = color_jitter(images, generator, strength)
        out = dict(batch)
        out["image"] = images
        if landmarks is not None:
            out["landmarks"] = landmarks
        return out

    return augment
