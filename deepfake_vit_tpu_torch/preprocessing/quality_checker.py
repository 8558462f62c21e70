"""Quality checking: thresholds, reasons and a batch API over the fused
quality ops.

Counterpart of ``deepfake_vit_tpu/preprocessing/quality_checker.py``:
``check_quality(image, landmarks, detection_info)`` → ``{is_valid,
overall_score, scores, reasons}`` with the five checks, the detection
confidence and the fixed weights of ``ops/quality.py::overall_quality``,
which runs batched on the checker's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quality import DEFAULT_THRESHOLDS, overall_quality

RAW_SCORES = ("face_size", "blur", "brightness", "contrast", "occlusion", "detection_confidence")


class QualityChecker:
    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        cfg = config or {}
        self.enabled = cfg.get("enabled", True)
        self.thresholds = {k: float(cfg.get(k, v)) for k, v in DEFAULT_THRESHOLDS.items()}
        self.check_occlusion = cfg.get("check_occlusion", True)
        self.device = resolve_device(device)

    @torch.inference_mode()
    def scores_tensors(self, images, landmarks, bboxes, confidences):
        """``overall_quality`` with this checker's thresholds on the device:
        (overall (B,), raw scores {name: (B,)})."""
        def dev(a):
            return torch.as_tensor(a).to(self.device, torch.float32)

        overall, _, raw = overall_quality(dev(images), dev(landmarks), dev(bboxes),
                                          dev(confidences), self.thresholds)
        return overall, {k: raw[k] for k in RAW_SCORES}

    def check_quality_batch(self, images, landmarks, bboxes, confidences) -> List[Dict[str, Any]]:
        """Batched quality check: (B, H, W, 3) RGB [0, 255] frames (host
        arrays or tensors) → one result dict a frame."""
        overall, raw = self.scores_tensors(images, landmarks, bboxes, confidences)
        overall = overall.cpu().numpy()
        raw = {k: v.cpu().numpy() for k, v in raw.items()}
        return [self.result(float(overall[i]), {k: float(raw[k][i]) for k in RAW_SCORES})
                for i in range(len(overall))]

    def result(self, overall: float, scores: Dict[str, float]) -> Dict[str, Any]:
        """One result dict: valid iff no reason is given (or checks are off)."""
        reasons = self._reasons(scores)
        return {"is_valid": (not reasons) if self.enabled else True, "overall_score": overall,
                "scores": scores, "reasons": reasons}

    def check_quality(self, image: np.ndarray, landmarks: np.ndarray,
                      detection_info: Dict[str, Any]) -> Dict[str, Any]:
        """Single-face API."""
        if not self.enabled:
            return {"is_valid": True, "overall_score": 1.0, "scores": {}, "reasons": []}
        return self.check_quality_batch(
            np.asarray(image, np.float32)[None],
            np.asarray(landmarks, np.float32)[None],
            np.asarray(detection_info["bbox"], np.float32)[None],
            np.asarray([detection_info.get("confidence", 1.0)], np.float32),
        )[0]

    def _reasons(self, scores: Dict[str, float]) -> List[str]:
        th = self.thresholds
        reasons = []
        fs = scores["face_size"]
        if not (th["min_face_size"] <= fs <= th["max_face_size"]):
            reasons.append(f"Face size out of range: {fs:.0f}px")
        if scores["blur"] < th["blur_threshold"]:
            reasons.append(f"Image too blurry: {scores['blur']:.1f}")
        if not (th["min_brightness"] <= scores["brightness"] <= th["max_brightness"]):
            reasons.append(f"Brightness out of range: {scores['brightness']:.1f}")
        if scores["contrast"] < th["min_contrast"]:
            reasons.append(f"Contrast too low: {scores['contrast']:.1f}")
        if self.check_occlusion and scores["occlusion"] < th["occlusion_threshold"]:
            reasons.append(f"Face occlusion detected: {scores['occlusion']:.2f}")
        return reasons


__all__ = ["QualityChecker"]
