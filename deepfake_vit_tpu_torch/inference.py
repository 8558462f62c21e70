"""End-to-end inference of a file's frames: detect → align → classify.

Counterpart of ``deepfake_vit_tpu/inference.py``. Every frame of a file is
detected in one batch and every frame with a face is aligned and
classified in one batched forward; the file's decision is the mean fake
probability over those frames against the threshold (0.5), and a file
with no face is real. Frames are padded to a multiple of ``max_batch``
before the classifier and the masked mean is taken on the device.

The aligner warps whole frames (``FaceAligner`` without ``warp_window``:
the JAX predictor builds it so too), through the warp kernel on a CUDA
device. Frames of one shape in a row are aligned in one call, so a video
clip makes one warp launch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .models.bridge import load_flax_variables
from .models.feature_extractor import create_model_from_config
from .models.layers import ensure_eval, init_weights
from .ops.image import normalize_imagenet
from .preprocessing.aligner import FaceAligner
from .preprocessing.detector import create_face_detector
from .utils.msgpack import msgpack_restore

PACKAGED_FORMAT = "dfv-classifier-v1"


class DeepfakePredictor:
    """Classifier and preprocessing of the predict CLI on one device.

    ``checkpoint_path``: a checkpoint written by either package's
    ``save_checkpoint`` (a flax msgpack dict; its ``params`` and
    ``batch_stats`` are loaded, anything else such as ``opt_state`` is
    ignored). The networks run in eval mode (``ensure_eval``). Without one the classifier keeps its seeded
    initialization (seed 0).
    """

    def __init__(
        self,
        model_config: Dict[str, Any],
        preprocessing_config: Dict[str, Any],
        checkpoint_path: Optional[str] = None,
        frame_count: int = 5,
        threshold: float = 0.5,
        max_batch: int = 32,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.frame_count = frame_count
        self.threshold = threshold
        self.max_batch = max_batch
        self.device = resolve_device(device)

        self.detector = create_face_detector(preprocessing_config.get("detection", {}),
                                             device=self.device)
        align_cfg = preprocessing_config.get("alignment", {})
        self.aligner = FaceAligner(
            output_size=tuple(align_cfg.get("output_size", (224, 224))),
            reference_landmarks=align_cfg.get("reference_landmarks"),
            method=align_cfg.get("method", "similarity"),
            device=self.device,
        )
        self.model = create_model_from_config(model_config.get("model", {}), dtype=dtype)
        init_weights(self.model, 0)
        self.model.to(self.device).eval()
        if checkpoint_path:
            self.load_variables(msgpack_restore(checkpoint_path))

    def load_variables(self, tree: Dict[str, Any]) -> None:
        """The classifier's weights from a flax tree with ``params`` and
        ``batch_stats``."""
        load_flax_variables(self.model, {"params": tree["params"],
                                         "batch_stats": tree.get("batch_stats", {})})

    @classmethod
    def from_packaged(cls, weights_path: str, preprocessing_config: Dict[str, Any],
                      **kwargs) -> "DeepfakePredictor":
        """A predictor from a self-describing packaged classifier
        (``format == "dfv-classifier-v1"``): the file carries the model
        config and the trained face size, so the predictor rebuilds the
        trained architecture whatever the caller's configuration says."""
        packaged = msgpack_restore(weights_path)
        if packaged.get("format") != PACKAGED_FORMAT:
            raise ValueError(f"{weights_path} is not a packaged classifier "
                             f"(format={packaged.get('format')!r})")
        face = int(packaged.get("face_size", 224))
        pre = {**preprocessing_config,
               "alignment": {**preprocessing_config.get("alignment", {}),
                             "output_size": [face, face]}}
        self = cls({"model": packaged["model_config"]}, pre, **kwargs)
        self.load_variables(packaged)
        return self

    @torch.inference_mode()
    def _predict(self, images: torch.Tensor, landmarks: torch.Tensor, mask: torch.Tensor):
        """Normalized faces (N, H, W, 3), aligned landmarks (N, 5, 2) and a
        validity mask (N,) on the device → (fake probability a face, their
        masked mean)."""
        ensure_eval(self.model)
        logits, _ = self.model(images, landmarks)
        fake = torch.softmax(logits, dim=-1)[:, 1]
        return fake, (fake * mask).sum() / mask.sum().clamp_min(1.0)

    # ------------------------------------------------------------------
    def preprocess_frame(self, rgb: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
        """detect → align → normalized model input (None without a face)."""
        det = self.detector.detect(rgb)
        if det is None:
            return None
        aligned, tform = self.aligner.align(rgb.astype(np.float32), det["landmarks"])
        aligned_lms = self.aligner.get_aligned_landmarks(det["landmarks"], tform)
        img = normalize_imagenet(torch.from_numpy(np.clip(aligned, 0, 255) / 255.0)).numpy()
        return {"image": img.astype(np.float32), "landmarks": aligned_lms.astype(np.float32)}

    def predict_frames(self, frames: Sequence[np.ndarray]) -> Dict[str, Any]:
        """The frames of one file → {label, fake_prob, frame_probs, num_faces}."""
        detections = self.detector.batch_detect(list(frames))
        hits = [(np.asarray(rgb), det) for rgb, det in zip(frames, detections) if det is not None]
        if not hits:
            return {"label": 0, "fake_prob": 0.0, "frame_probs": [], "num_faces": 0}

        # One aligner call for each run of frames of one shape (a video's
        # frames are one run), the frames crossing in their own dtype.
        aligned_parts: List[torch.Tensor] = []
        lms_parts: List[torch.Tensor] = []
        i = 0
        while i < len(hits):
            j = i + 1
            while j < len(hits) and hits[j][0].shape == hits[i][0].shape:
                j += 1
            aligned, aligned_lms, _ = self.aligner.align_tensors(
                np.stack([h[0] for h in hits[i:j]]),
                np.stack([np.asarray(h[1]["landmarks"], np.float32) for h in hits[i:j]]))
            aligned_parts.append(aligned)
            lms_parts.append(aligned_lms)
            i = j
        images = normalize_imagenet(torch.cat(aligned_parts).clamp(0.0, 255.0) / 255.0)
        lms = torch.cat(lms_parts)

        # Pad to a multiple of max_batch; padded slots are masked out.
        n = len(hits)
        pad = self.max_batch - (n % self.max_batch or self.max_batch)
        mask = torch.ones(n + pad, device=self.device)
        if pad:
            images = torch.cat([images, images.new_zeros((pad, *images.shape[1:]))])
            lms = torch.cat([lms, lms.new_zeros((pad, 5, 2))])
            mask[n:] = 0.0
        fake, mean_fake = self._predict(images, lms, mask)
        mean_fake = float(mean_fake)
        return {"label": int(mean_fake >= self.threshold), "fake_prob": mean_fake,
                "frame_probs": fake[:n].float().cpu().tolist(), "num_faces": n}

    def predict_image(self, rgb: np.ndarray) -> Dict[str, Any]:
        return self.predict_frames([rgb])


__all__ = ["DeepfakePredictor", "PACKAGED_FORMAT"]
