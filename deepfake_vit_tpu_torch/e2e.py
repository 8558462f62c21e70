"""Fused end-to-end pipeline: detect → align → quality → classify per batch.

One call runs the SCRFD forward (its first conv folding the 2× pool from
serving to detection resolution), anchor decode, best-face selection,
Umeyama solve, the fractional windowed warp (hand-written crop and warp
kernels), quality scoring, ImageNet normalization and the
EfficientNet + attention classifier — all on the pipeline's device, with
static shapes and no host round-trip between stages.

This slice of the port covers ``keep_top_k=1``, the fractional windowed
warp with legacy taps, bf16 or float32, and the SCRFD detector family.
Every other option of the JAX pipeline raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .models.bridge import load_flax_variables
from .models.feature_extractor import create_model_from_config
from .models.layers import init_weights
from .ops.anchors import STRIDES, all_anchor_centers, decode_boxes, decode_landmarks
from .ops.image import normalize_imagenet
from .ops.quality import overall_quality
from .ops.umeyama import transform_points, umeyama
from .ops.warp import _avg_pool2, warp_affine_windowed
from .ops.warp_kernel import warp_affine_legacy
from .preprocessing.aligner import DEFAULT_REFERENCE_LANDMARKS, _LANDMARK_ORDER
from .preprocessing.detector import build_detection_net, default_weights_path
from .utils.msgpack import msgpack_restore

_NEXT_SLICE = "the int8 slice, the next slice of the port"
_LATER_SLICE = "a later slice of the port"


def _not_ported(option: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet: it belongs to {slice_name}")


class FusedPipeline:
    """detect+align+quality+classify in one call.

    ``forward(frames)`` with frames (B, H, W, 3) RGB [0, 255] at serving
    size (uint8 preferred) returns a dict of per-frame tensors: every frame
    yields its best face with a validity flag. Weights come from
    ``init_variables`` (seeded) or ``load_variables`` (seeded, then the
    committed detector weights and an optional classifier checkpoint).
    """

    def __init__(
        self,
        model_config: Dict[str, Any],
        detection_input_size: Tuple[int, int] = (640, 640),
        output_size: Tuple[int, int] = (224, 224),
        confidence_threshold: float = 0.5,
        reference_landmarks: Optional[Dict[str, Tuple[float, float]]] = None,
        serving_size: Optional[Tuple[int, int]] = None,
        warp_window: int = 160,
        warp_fractional: bool = False,
        warp_tap_mode: str = "legacy",
        dtype: torch.dtype = torch.bfloat16,
        use_fused_backbone: bool = False,
        use_int8_tail: bool = False,
        use_s2d_early: bool = False,
        use_int8_detector: bool = False,
        keep_top_k: int = 1,
        detector_arch: str = "scrfd",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if use_int8_tail:
            raise _not_ported("use_int8_tail (s8 GEMM late-stage tail)", _NEXT_SLICE)
        if use_int8_detector:
            raise _not_ported("use_int8_detector (s8 implicit-GEMM SCRFD convs)", _NEXT_SLICE)
        if keep_top_k != 1:
            raise _not_ported("keep_top_k > 1 (multi-face serving with NMS)", _LATER_SLICE)
        if warp_tap_mode != "legacy":
            raise _not_ported(f"warp_tap_mode={warp_tap_mode!r}", _LATER_SLICE)
        if detector_arch != "scrfd":
            raise _not_ported(f"detector_arch={detector_arch!r}", _LATER_SLICE)
        if use_s2d_early:
            raise _not_ported("use_s2d_early", _LATER_SLICE)
        if use_fused_backbone:
            raise _not_ported("use_fused_backbone (fused MBConv kernels)", _LATER_SLICE)

        self.device = resolve_device(device)
        self.dtype = dtype
        self.input_size = tuple(detection_input_size)
        self.serving_size = tuple(serving_size or detection_input_size)
        self.output_size = tuple(output_size)
        self.warp_window = warp_window
        self.confidence_threshold = confidence_threshold
        self._windowed = min(self.serving_size) > warp_window
        if self._windowed and not warp_fractional:
            raise _not_ported("warp_fractional=False (pooled windowed warp)", _LATER_SLICE)
        ratio = self.serving_size[0] // self.input_size[0]
        if (
            self.serving_size[0] != self.input_size[0] * ratio
            or self.serving_size[1] != self.input_size[1] * ratio
            or ratio & (ratio - 1)
        ):
            raise ValueError(
                f"serving_size {self.serving_size} must be a power-of-2 "
                f"multiple of detection_input_size {self.input_size}"
            )
        self._pool_ratio = ratio
        # One 2× pool level folds into the detector's first conv exactly.
        self._stem_fold = 2 if ratio >= 2 else 1

        self.detector = build_detection_net(detector_arch, dtype=dtype,
                                            stem_pool=self._stem_fold).to(self.device).eval()
        self.model = create_model_from_config(model_config.get("model", {}),
                                              dtype=dtype).to(self.device).eval()
        self._initialized = False

        centers, strides = all_anchor_centers(self.input_size)
        self._centers = torch.as_tensor(centers, device=self.device)
        self._strides = torch.as_tensor(strides, device=self.device)
        ref = {**DEFAULT_REFERENCE_LANDMARKS, **(reference_landmarks or {})}
        self.reference = torch.as_tensor(
            np.asarray([ref[k] for k in _LANDMARK_ORDER], np.float32)
            * np.asarray([self.output_size[1], self.output_size[0]], np.float32),
            device=self.device,
        )

    # ------------------------------------------------------------------
    def init_variables(self, seed: int = 0):
        """Seeded flax-default init of both networks (random weights; load
        real ones on top). Returns (detector, model)."""
        init_weights(self.detector, seed)
        init_weights(self.model, seed + 1)
        self._initialized = True
        return self.detector, self.model

    def load_variables(self, seed: int = 0, classifier_checkpoint: Optional[str] = None,
                       detector_weights: Optional[str] = "default"):
        """Init, then overlay trained weights from flax msgpack files.

        ``detector_weights="default"`` loads the committed SCRFD weights
        (None keeps the seeded init); ``classifier_checkpoint`` is a
        framework checkpoint (msgpack with ``params``/``batch_stats``).
        """
        self.init_variables(seed)
        if detector_weights == "default":
            detector_weights = default_weights_path("scrfd")
        if classifier_checkpoint:
            ckpt = msgpack_restore(classifier_checkpoint)
            load_flax_variables(self.model, {"params": ckpt["params"],
                                             "batch_stats": ckpt["batch_stats"]})
        if detector_weights:
            load_flax_variables(self.detector, msgpack_restore(detector_weights))
        return self.detector, self.model

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, frames) -> Dict[str, torch.Tensor]:
        """frames: (B, H, W, 3) RGB [0, 255] at serving size, uint8 or float,
        numpy or tensor. Returns per-frame tensors on the pipeline's device."""
        if not self._initialized:
            raise RuntimeError("call init_variables or load_variables before forward")
        return self._graph(torch.as_tensor(frames).to(self.device))

    def _graph(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        # Frame-side compute in the pipeline dtype: the warp quantizes
        # pixels to bf16 regardless.
        frames = frames.to(self.dtype)

        # 0. Detection canvas: pool down to stem_fold× the detection size;
        #    the final 2× rides the folded first conv.
        det_frames = frames
        while det_frames.shape[1] > self.input_size[0] * self._stem_fold:
            det_frames = _avg_pool2(det_frames)

        # 1. Detection network + decode; the best face is the argmax.
        outs = self.detector((det_frames - 127.5) / 128.0)
        scores = torch.cat([torch.sigmoid(outs[s]["scores"]) for s in STRIDES], dim=1)
        dist = torch.cat([outs[s]["bbox"] for s in STRIDES], dim=1)
        kps = torch.cat([outs[s]["kps"] for s in STRIDES], dim=1)
        boxes = decode_boxes(self._centers, self._strides, dist)
        landmarks = decode_landmarks(self._centers, self._strides, kps)
        best = scores.argmax(dim=1)
        rows = torch.arange(scores.shape[0], device=scores.device)
        conf = scores[rows, best]
        bbox = boxes[rows, best]
        lms = landmarks[rows, best]
        has_face = conf >= self.confidence_threshold

        # Canvas → serving coords (pixel centers: u_s = r·u + (r−1)/2).
        r = self._pool_ratio
        if r > 1:
            shift = 0.5 * (r - 1)
            bbox = bbox * r + shift
            lms = lms * r + shift

        # 2. Alignment: batched Umeyama + warp from the serving frames.
        tform = umeyama(lms, self.reference.expand(lms.shape))
        if self._windowed:
            aligned = warp_affine_windowed(frames, tform, self.output_size,
                                           window=self.warp_window, fractional=True)
        else:
            aligned = warp_affine_legacy(frames, tform, self.output_size)
        aligned_lms = transform_points(tform, lms)

        # 3. Quality scoring on the aligned face.
        quality, q_valid, _ = overall_quality(aligned, aligned_lms, bbox, conf)

        # 4. Classification.
        logits, features = self.model(normalize_imagenet(aligned / 255.0), aligned_lms)
        probs = torch.softmax(logits, dim=-1)
        return {
            "has_face": has_face,
            "confidence": conf,
            "bbox": bbox,
            "landmarks": aligned_lms,
            "quality": quality,
            "quality_valid": q_valid,
            "probs": probs,
            "fake_prob": torch.where(has_face, probs[:, 1], torch.zeros_like(probs[:, 1])),
            "features": features,
        }

    # ------------------------------------------------------------------
    def predict_clip(self, frames, threshold: float = 0.5) -> Dict[str, Any]:
        """Clip-level aggregation: mean fake-prob over frames with faces."""
        out = self.forward(frames)
        mask = out["has_face"].float().cpu().numpy()
        fake_probs = out["fake_prob"].float().cpu().numpy()
        denom = max(mask.sum(), 1.0)
        fake = float((fake_probs * mask).sum() / denom)
        return {
            "label": int(fake >= threshold and mask.sum() > 0),
            "fake_prob": fake,
            "num_faces": int(mask.sum()),
            "frame_probs": fake_probs.tolist(),
        }
