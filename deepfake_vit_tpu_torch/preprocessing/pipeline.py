"""Preprocessing pipeline: detect → quality → align → save.

Counterpart of ``deepfake_vit_tpu/preprocessing/pipeline.py``: the
``PreprocessingOutput`` record (aligned face, landmarks, quality, bbox,
confidence, transform, ids and labels) with its model-input conversion;
``process_image`` and ``process_batch``, where a face of invalid quality is
flagged but still processed; the on-disk layout faces/ landmarks/
metadata/ named ``{dataset}_{label}_{image_id}``, ``load_output``;
statistics; the YAML factory.

``process_batch`` is batched on the pipeline's device. A batch whose
frames all have the detection canvas's shape runs as one device graph
(detect, best face, quality, align, uint8 faces) with one copy in and one
out; other batches letterbox each frame for detection and run quality and
alignment once per group of frames of one shape. ``save_output``,
``load_output`` and the YAML factory import ``cv2`` and ``yaml`` when
called.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from .aligner import FaceAligner, NormalizationProcessor
from .detector import FaceDetector, create_face_detector
from .quality_checker import QualityChecker

_NO_CHECK = {"is_valid": True, "overall_score": 1.0, "scores": {}, "reasons": []}


@dataclass
class PreprocessingOutput:
    """One processed face."""

    aligned_face: Optional[np.ndarray] = None  # (H, W, 3) uint8 RGB
    landmarks: Optional[np.ndarray] = None     # (5, 2) aligned-image coordinates
    original_landmarks: Optional[np.ndarray] = None
    bbox: Optional[np.ndarray] = None
    confidence: float = 0.0
    quality_score: float = 0.0
    quality_details: Dict[str, Any] = field(default_factory=dict)
    tform: Optional[np.ndarray] = None
    image_id: Optional[str] = None
    dataset: Optional[str] = None
    label: Optional[str] = None
    success: bool = False
    failure_reason: Optional[str] = None

    def to_model_input(self, normalize: bool = True) -> Dict[str, np.ndarray]:
        """Aligned face → normalized NHWC float32 image and landmarks."""
        img = np.asarray(self.aligned_face, dtype=np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if normalize:
            proc = NormalizationProcessor()
            img = (img - proc.mean) / proc.std
        return {"image": img, "landmarks": np.asarray(self.landmarks, dtype=np.float32)}


class PreprocessingPipeline:
    def __init__(self, config: Dict[str, Any], device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)
        self.detector: FaceDetector = create_face_detector(config.get("detection", {}),
                                                           device=self.device)
        align_cfg = config.get("alignment", {})
        self.aligner = FaceAligner(
            output_size=tuple(align_cfg.get("output_size", (224, 224))),
            reference_landmarks=align_cfg.get("reference_landmarks"),
            method=align_cfg.get("method", "similarity"),
            border_value=float(align_cfg.get("border_value", 0)),
            warp_window=align_cfg.get("warp_window"),
            warp_fractional=bool(align_cfg.get("warp_fractional", True)),
            device=self.device,
        )
        self.quality_checker = QualityChecker(config.get("quality", {}), device=self.device)
        pipe_cfg = config.get("pipeline", {})
        norm_cfg = pipe_cfg.get("normalize", {})
        self.normalizer = NormalizationProcessor(
            mean=tuple(norm_cfg.get("mean", (0.485, 0.456, 0.406))),
            std=tuple(norm_cfg.get("std", (0.229, 0.224, 0.225))),
        )
        self.save_format = pipe_cfg.get("save_format", "png")
        self.jpg_quality = int(pipe_cfg.get("jpg_quality", 95))
        self._stats: List[PreprocessingOutput] = []

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _fused_graph(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detect → best face → quality → align of frames at the canvas
        size, on the device, with the modular stages' own functions."""
        out = self.detector._detect_graph(frames)
        # The best valid face: the first maximum, as the host-side argsort picks.
        best = torch.where(out["valid"], out["scores"], float("-inf")).argmax(dim=1)
        rows = torch.arange(frames.shape[0], device=frames.device)
        bbox, lms = out["boxes"][rows, best], out["landmarks"][rows, best]
        conf = out["scores"][rows, best]
        aligned, aligned_lms, tforms = self.aligner.align_tensors(frames, lms, out_uint8=True)
        res = {"bbox": bbox, "landmarks": lms, "confidence": conf,
               "num_faces": out["valid"].sum(dim=1), "aligned": aligned,
               "aligned_lms": aligned_lms, "tforms": tforms}
        if self.quality_checker.enabled:
            res["q_overall"], res["q_raw"] = self.quality_checker.scores_tensors(
                frames, lms, bbox, conf)
        return res

    def process_image(self, image: np.ndarray, image_id: Optional[str] = None,
                      dataset: Optional[str] = None, label: Optional[str] = None
                      ) -> PreprocessingOutput:
        """Single RGB uint8 image → PreprocessingOutput."""
        return self.process_batch([image], [image_id], [dataset], [label])[0]

    def process_batch(
        self,
        images: Sequence[np.ndarray],
        image_ids: Optional[Sequence[Optional[str]]] = None,
        datasets: Optional[Sequence[Optional[str]]] = None,
        labels: Optional[Sequence[Optional[str]]] = None,
    ) -> List[PreprocessingOutput]:
        n = len(images)
        image_ids = image_ids or [None] * n
        datasets = datasets or [None] * n
        labels = labels or [None] * n
        H, W = self.detector.input_size
        if n and all(np.asarray(im).shape == (H, W, 3) for im in images):
            return self._process_batch_fused(images, image_ids, datasets, labels)
        detections = self.detector.batch_detect(list(images))

        outputs: List[PreprocessingOutput] = []
        det_idx: List[int] = []
        for i, det in enumerate(detections):
            out = PreprocessingOutput(image_id=image_ids[i], dataset=datasets[i], label=labels[i])
            if det is None:
                out.failure_reason = "no_face_detected"
            else:
                out.bbox = det["bbox"]
                out.original_landmarks = det["landmarks"]
                out.confidence = det["confidence"]
                det_idx.append(i)
            outputs.append(out)

        # Quality and alignment once per group of frames of one shape, from
        # one host → device copy of the group in its own dtype.
        by_shape: Dict[tuple, List[int]] = {}
        for i in det_idx:
            by_shape.setdefault(np.asarray(images[i]).shape, []).append(i)
        for idxs in by_shape.values():
            imgs = torch.as_tensor(np.stack([np.asarray(images[i]) for i in idxs])).to(self.device)
            lms = np.stack([outputs[i].original_landmarks for i in idxs])
            if self.quality_checker.enabled:
                qs = self.quality_checker.check_quality_batch(
                    imgs, lms, np.stack([outputs[i].bbox for i in idxs]),
                    np.asarray([outputs[i].confidence for i in idxs], np.float32))
            else:
                qs = [dict(_NO_CHECK) for _ in idxs]
            aligned, aligned_lms, tforms = self.aligner.align_batch(imgs, lms, out_uint8=True)
            for k, i in enumerate(idxs):
                outputs[i].quality_score = qs[k]["overall_score"]
                outputs[i].quality_details = qs[k]
                outputs[i].aligned_face = aligned[k]
                outputs[i].landmarks = aligned_lms[k]
                outputs[i].tform = tforms[k]
                outputs[i].success = True

        self._stats.extend(outputs)
        return outputs

    def _process_batch_fused(self, images, image_ids, datasets, labels
                             ) -> List[PreprocessingOutput]:
        """A batch of canvas-sized frames through ``_fused_graph``."""
        frames = torch.as_tensor(np.stack([np.asarray(im) for im in images])).to(self.device)
        res = self._fused_graph(frames)
        q_raw = res.pop("q_raw", None)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        if q_raw is not None:
            q_raw = {k: v.cpu().numpy() for k, v in q_raw.items()}

        outputs: List[PreprocessingOutput] = []
        for i in range(len(images)):
            out = PreprocessingOutput(image_id=image_ids[i], dataset=datasets[i], label=labels[i])
            outputs.append(out)
            if int(res["num_faces"][i]) == 0:
                out.failure_reason = "no_face_detected"
                continue
            out.bbox = res["bbox"][i].astype(np.float32)
            out.original_landmarks = res["landmarks"][i].astype(np.float32)
            out.confidence = float(res["confidence"][i])
            if q_raw is not None:
                out.quality_details = self.quality_checker.result(
                    float(res["q_overall"][i]), {k: float(v[i]) for k, v in q_raw.items()})
            else:
                out.quality_details = dict(_NO_CHECK)
            out.quality_score = out.quality_details["overall_score"]
            out.aligned_face = res["aligned"][i]
            out.landmarks = res["aligned_lms"][i]
            out.tform = res["tforms"][i]
            out.success = True

        self._stats.extend(outputs)
        return outputs

    # ------------------------------------------------------------------
    def save_output(self, output: PreprocessingOutput, base_dir: Union[Path, str]
                    ) -> Dict[str, str]:
        """Write the faces/ landmarks/ metadata/ files; returns their paths
        relative to ``base_dir``."""
        import cv2

        base = Path(base_dir)
        stem = f"{output.dataset}_{output.label}_{output.image_id}"
        faces_dir, lm_dir, meta_dir = base / "faces", base / "landmarks", base / "metadata"
        for d in (faces_dir, lm_dir, meta_dir):
            d.mkdir(parents=True, exist_ok=True)

        paths = {}
        face_path = faces_dir / f"{stem}.{self.save_format}"
        bgr = cv2.cvtColor(output.aligned_face, cv2.COLOR_RGB2BGR)
        if self.save_format == "jpg":
            cv2.imwrite(str(face_path), bgr, [cv2.IMWRITE_JPEG_QUALITY, self.jpg_quality])
        else:
            cv2.imwrite(str(face_path), bgr)
        paths["face_path"] = str(face_path.relative_to(base))

        lm_path = lm_dir / f"{stem}.npy"
        np.save(lm_path, output.landmarks)
        paths["landmark_path"] = str(lm_path.relative_to(base))

        meta_path = meta_dir / f"{stem}.json"
        meta = {
            "image_id": output.image_id,
            "dataset": output.dataset,
            "label": output.label,
            "bbox": _tolist(output.bbox),
            "confidence": float(output.confidence),
            "quality_score": float(output.quality_score),
            "quality_details": _jsonable(output.quality_details),
            "tform": _tolist(output.tform),
            "original_landmarks": _tolist(output.original_landmarks),
        }
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=2)
        paths["metadata_path"] = str(meta_path.relative_to(base))
        return paths

    def load_output(self, base_dir: Union[Path, str], stem: str) -> PreprocessingOutput:
        import cv2

        base = Path(base_dir)
        face_path = base / "faces" / f"{stem}.{self.save_format}"
        bgr = cv2.imread(str(face_path))
        if bgr is None:
            raise FileNotFoundError(face_path)
        with open(base / "metadata" / f"{stem}.json") as f:
            meta = json.load(f)
        return PreprocessingOutput(
            aligned_face=cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB),
            landmarks=np.load(base / "landmarks" / f"{stem}.npy"),
            original_landmarks=_toarr(meta.get("original_landmarks")),
            bbox=_toarr(meta.get("bbox")),
            confidence=meta.get("confidence", 0.0),
            quality_score=meta.get("quality_score", 0.0),
            quality_details=meta.get("quality_details", {}),
            tform=_toarr(meta.get("tform")),
            image_id=meta.get("image_id"),
            dataset=meta.get("dataset"),
            label=meta.get("label"),
            success=True,
        )

    # ------------------------------------------------------------------
    def get_statistics(self) -> Dict[str, Any]:
        total = len(self._stats)
        success = [o for o in self._stats if o.success]
        valid = [o for o in success if o.quality_details.get("is_valid", True)]
        qs = [o.quality_score for o in success]
        failures: Dict[str, int] = {}
        for o in self._stats:
            if not o.success:
                failures[str(o.failure_reason)] = failures.get(str(o.failure_reason), 0) + 1
        return {
            "total_processed": total,
            "successful": len(success),
            "failed": total - len(success),
            "success_rate": len(success) / total if total else 0.0,
            "quality_valid": len(valid),
            "quality_mean": float(np.mean(qs)) if qs else 0.0,
            "quality_std": float(np.std(qs)) if qs else 0.0,
            "failure_reasons": failures,
        }

    def reset_statistics(self) -> None:
        self._stats = []


def _tolist(arr):
    return None if arr is None else np.asarray(arr).tolist()


def _toarr(lst):
    return None if lst is None else np.asarray(lst, dtype=np.float32)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.generic, np.ndarray)):
        return obj.tolist()
    return obj


def create_pipeline_from_config(config_path: Union[Path, str],
                                device: Optional[Union[str, torch.device]] = None
                                ) -> PreprocessingPipeline:
    """A pipeline from a preprocessing YAML file."""
    import yaml

    with open(config_path) as f:
        return PreprocessingPipeline(yaml.safe_load(f), device=device)


__all__ = ["PreprocessingOutput", "PreprocessingPipeline", "create_pipeline_from_config"]
