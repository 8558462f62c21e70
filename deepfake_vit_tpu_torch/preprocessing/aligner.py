"""Face alignment to the 5-point template, and ImageNet normalization.

Counterpart of ``deepfake_vit_tpu/preprocessing/aligner.py``: the template
(eyes at y = 0.32, x = 0.31 / 0.69; nose (0.50, 0.55); mouth at y = 0.75,
x = 0.35 / 0.65, of the output size), 'similarity' (Umeyama) or 'affine'
(first three points) estimation, the aligned landmarks, an alignment
quality score and ``NormalizationProcessor``.

The estimate and the warp run batched on the aligner's device. The warp is
chosen as the JAX ``_align_graph`` chooses it: the windowed warp of the
serving pipeline (``ops/warp.py::warp_affine_windowed``) when
``warp_window`` is set and the frame holds a window; else, with a zero
border, the whole frame through the warp kernel (``warp_affine_auto``:
``warp_affine_legacy`` on a CUDA device, its plain version on the CPU);
else the exact float32 warp, the only one with another border value.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.umeyama import affine_from_3pts, transform_points, umeyama
from ..ops.warp import warp_affine, warp_affine_auto, warp_affine_windowed

DEFAULT_REFERENCE_LANDMARKS = {
    "left_eye": (0.31, 0.32),
    "right_eye": (0.69, 0.32),
    "nose": (0.50, 0.55),
    "left_mouth": (0.35, 0.75),
    "right_mouth": (0.65, 0.75),
}
_LANDMARK_ORDER = ("left_eye", "right_eye", "nose", "left_mouth", "right_mouth")


class FaceAligner:
    def __init__(
        self,
        output_size: Tuple[int, int] = (224, 224),
        reference_landmarks: Optional[Dict[str, Tuple[float, float]]] = None,
        method: str = "similarity",
        border_value: float = 0.0,
        warp_window: Optional[int] = None,
        warp_fractional: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if method not in ("similarity", "affine"):
            raise ValueError(f"unknown alignment method: {method}")
        self.output_size = tuple(output_size)
        # Sources larger than the window go through the serving pipeline's
        # windowed warp, so that offline crops carry its fidelity; None
        # warps the whole frame.
        self.warp_window = int(warp_window) if warp_window else None
        self.warp_fractional = bool(warp_fractional)
        self.method = method
        self.border_value = border_value
        self.device = resolve_device(device)
        ref = {**DEFAULT_REFERENCE_LANDMARKS, **(reference_landmarks or {})}
        # Normalized template coordinates → output pixels.
        self.reference = np.asarray([ref[k] for k in _LANDMARK_ORDER], dtype=np.float32) \
            * np.asarray([self.output_size[1], self.output_size[0]], dtype=np.float32)
        self._reference = torch.as_tensor(self.reference, device=self.device)

    # -- device graph -------------------------------------------------------
    def _estimate(self, landmarks: torch.Tensor) -> torch.Tensor:
        ref = self._reference.expand(landmarks.shape)
        if self.method == "similarity":
            return umeyama(landmarks, ref)
        return affine_from_3pts(landmarks[..., :3, :], ref[..., :3, :])

    @torch.inference_mode()
    def align_tensors(self, images, landmarks, out_uint8: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) uint8/float RGB, landmarks (B, 5, 2) source
        pixels, host arrays or tensors. Returns (aligned (B, Ho, Wo, 3)
        float32, or uint8 clipped and truncated with ``out_uint8``, aligned
        landmarks, 2×3 transforms), on the aligner's device."""
        images = torch.as_tensor(images).to(self.device)
        landmarks = torch.as_tensor(landmarks).to(self.device, torch.float32)
        tform = self._estimate(landmarks)
        H, W = images.shape[1], images.shape[2]
        if (self.warp_window is not None and self.border_value == 0.0
                and min(H, W) >= self.warp_window and H % 8 == 0 and self.warp_window % 8 == 0):
            aligned = warp_affine_windowed(images, tform, self.output_size,
                                           window=self.warp_window,
                                           fractional=self.warp_fractional)
        elif self.border_value == 0.0:
            aligned = warp_affine_auto(images, tform, self.output_size)
        else:  # another border value: only the exact warp has it
            aligned = warp_affine(images.float(), tform, self.output_size, self.border_value)
        if out_uint8:  # float → uint8 truncates toward zero, as numpy's astype does
            aligned = aligned.clamp(0.0, 255.0).to(torch.uint8)
        return aligned, transform_points(tform, landmarks), tform

    # -- host API -----------------------------------------------------------
    def align(self, image: np.ndarray, landmarks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Single-face align → (aligned image, 2×3 transform), numpy."""
        aligned, _, tform = self.align_tensors(np.asarray(image, np.float32)[None],
                                               np.asarray(landmarks, np.float32)[None])
        return aligned[0].cpu().numpy(), tform[0].cpu().numpy()

    def align_batch(self, images, landmarks, out_uint8: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched align: (B, H, W, 3), (B, 5, 2) → aligned, aligned
        landmarks, transforms, numpy. ``images`` may be a host array (uint8
        crosses to the device at a quarter of float32's bytes) or a tensor
        already on the device; ``out_uint8`` clips and casts on the device
        before the copy back."""
        return tuple(t.cpu().numpy() for t in self.align_tensors(images, landmarks, out_uint8))

    def get_aligned_landmarks(self, landmarks: np.ndarray, tform: np.ndarray) -> np.ndarray:
        """Landmarks mapped by a 2×3 matrix."""
        return transform_points(torch.as_tensor(np.asarray(tform, np.float32))[None],
                                torch.as_tensor(np.asarray(landmarks, np.float32))[None])[0].numpy()

    def compute_alignment_quality(self, aligned_landmarks: np.ndarray) -> float:
        """Mean distance to the template normalized by its inter-eye
        distance, mapped to [0, 1]."""
        ied = np.linalg.norm(self.reference[1] - self.reference[0])
        dists = np.linalg.norm(aligned_landmarks - self.reference, axis=-1)
        return float(max(0.0, 1.0 - dists.mean() / max(ied, 1e-6)))


class NormalizationProcessor:
    """ImageNet normalize and denormalize on host arrays."""

    def __init__(
        self,
        mean: Tuple[float, float, float] = (0.485, 0.456, 0.406),
        std: Tuple[float, float, float] = (0.229, 0.224, 0.225),
    ):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def normalize(self, image: np.ndarray) -> np.ndarray:
        """uint8/float [0, 255] or [0, 1] RGB → normalized float32."""
        img = np.asarray(image, dtype=np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        return (img - self.mean) / self.std

    def denormalize(self, image: np.ndarray, to_uint8: bool = False) -> np.ndarray:
        img = np.asarray(image, dtype=np.float32) * self.std + self.mean
        img = np.clip(img, 0.0, 1.0)
        return (img * 255.0).astype(np.uint8) if to_uint8 else img


__all__ = ["DEFAULT_REFERENCE_LANDMARKS", "FaceAligner", "NormalizationProcessor"]
