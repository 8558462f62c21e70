"""From preprocessing outputs to model batches.

Counterpart of the JAX package's ``data/interface.py``:
``FeatureExtractionInput`` (stacked NHWC images, landmarks, quality
scores, labels and ids), ``PreprocessingToFeatureInterface`` (preprocessing
outputs or a loader batch → ``FeatureExtractionInput``; the interface's
per-sample-normalized landmark maps through ``ops/gaussian.py``) and
``collate_preprocessing_outputs``. ``to_device(device)`` takes the place
of JAX's ``to_device(mesh)``; the batch helper is
``data/dataset.py::batch_to_device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .dataset import IMAGENET_MEAN, IMAGENET_STD, LABEL_MAP, batch_to_device


@dataclass
class FeatureExtractionInput:
    """One model-ready batch (NHWC images, 5-point landmarks)."""

    images: np.ndarray                     # (B, H, W, 3) float32 normalized
    landmarks: Optional[np.ndarray] = None  # (B, 5, 2)
    quality_scores: Optional[np.ndarray] = None  # (B,)
    labels: Optional[np.ndarray] = None    # (B,) int32, real=0/fake=1
    image_ids: List[str] = field(default_factory=list)
    batch_metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def batch_size(self) -> int:
        return int(self.images.shape[0])

    def to_device(self, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
        """The numeric fields as a model batch dict of tensors on ``device``."""
        batch: Dict[str, Any] = {"image": self.images}
        if self.landmarks is not None:
            batch["landmarks"] = self.landmarks
        if self.labels is not None:
            batch["label"] = self.labels
        if self.quality_scores is not None:
            batch["quality_score"] = self.quality_scores
        return batch_to_device({k: np.asarray(v) for k, v in batch.items()}, torch.device(device))


class PreprocessingToFeatureInterface:
    """Stacks ``PreprocessingOutput`` records into model batches."""

    def __init__(self, image_size: int = 224, normalize: bool = True):
        self.image_size = image_size
        self.normalize = normalize

    def preprocessing_outputs_to_batch(self, outputs: Sequence[Any]) -> FeatureExtractionInput:
        """Faces arrive as uint8 RGB; they are scaled to [0, 1] (by dtype,
        not by value: a dark uint8 face is still divided by 255) and
        ImageNet-normalized."""
        images, landmarks, qualities, labels, ids = [], [], [], [], []
        for out in outputs:
            raw = np.asarray(out.aligned_face)
            img = raw.astype(np.float32)
            if np.issubdtype(raw.dtype, np.integer) or img.max() > 1.5:
                img = img / 255.0
            if self.normalize:
                img = (img - IMAGENET_MEAN) / IMAGENET_STD
            images.append(img)
            landmarks.append(np.asarray(out.landmarks, dtype=np.float32)
                             if out.landmarks is not None else np.zeros((5, 2), np.float32))
            qualities.append(float(out.quality_score))
            labels.append(LABEL_MAP.get(str(out.label), 0))
            ids.append(str(out.image_id))
        return FeatureExtractionInput(
            images=np.stack(images),
            landmarks=np.stack(landmarks),
            quality_scores=np.array(qualities, dtype=np.float32),
            labels=np.array(labels, dtype=np.int32),
            image_ids=ids,
            batch_metadata={"count": len(outputs)},
        )

    def dataloader_batch_to_feature_input(self, batch: Dict[str, Any]) -> FeatureExtractionInput:
        """A loader batch dict as a ``FeatureExtractionInput``."""
        return FeatureExtractionInput(
            images=np.asarray(batch["image"], dtype=np.float32),
            landmarks=(np.asarray(batch["landmarks"], dtype=np.float32)
                       if "landmarks" in batch else None),
            quality_scores=(np.asarray(batch.get("quality_score"), dtype=np.float32)
                            if "quality_score" in batch else None),
            labels=np.asarray(batch["label"], dtype=np.int32) if "label" in batch else None,
            image_ids=list(batch.get("image_id", [])),
        )

    def create_landmark_attention_maps(self, landmarks: np.ndarray, feature_size: Tuple[int, int],
                                       sigma: float = 1.5, input_size: float = 224.0) -> np.ndarray:
        """(B, 1, H, W) Gaussian maps, each sample normalized by its own
        maximum, not clamped (unlike the attention module's global maximum
        and [0.1, 1] clamp)."""
        from ..ops.gaussian import landmark_gaussian_map

        maps = landmark_gaussian_map(torch.as_tensor(np.asarray(landmarks, dtype=np.float32)),
                                     feature_size, sigma=sigma, input_size=input_size,
                                     normalize="per_sample", clip_range=None)
        return maps.numpy()

    def prepare_for_efficientnet(self, fe: FeatureExtractionInput,
                                 device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
        return fe.to_device(device)


def collate_preprocessing_outputs(outputs: Sequence[Any]) -> FeatureExtractionInput:
    """``preprocessing_outputs_to_batch`` with the default interface."""
    return PreprocessingToFeatureInterface().preprocessing_outputs_to_batch(outputs)


__all__ = ["FeatureExtractionInput", "PreprocessingToFeatureInterface",
           "collate_preprocessing_outputs"]
