"""Fused end-to-end pipeline: detect → align → quality → classify per batch.

One call runs the SCRFD forward (its first conv folding the 2× pool from
serving to detection resolution), anchor decode, best-face selection,
Umeyama solve, the windowed warp (hand-written crop and warp kernels),
quality scoring, ImageNet normalization and the EfficientNet + attention
classifier — all on the pipeline's device, with static shapes and no host
round-trip between stages.

Ported: ``keep_top_k=1``; the pooled windowed warp (the class default) and
the fractional one, both with legacy taps; bf16 or float32; the SCRFD
detector family, in its own dtype or as the int8 graph
(``use_int8_detector``); the int8 late-stage classifier tail
(``use_int8_tail``) with ``calibrate_int8``/``calibrate_int8_detector``;
the fused early backbone stages (``use_fused_backbone``: stem and MBConv
blocks through the fused kernels, which wins over the int8 tail when both
are set, as in the JAX graph); ``compute_quality=False``. Every other
option of the JAX pipeline (``keep_top_k > 1``, the ``uw``/``uw16``/``int8``
tap modes, the lite detector, ``use_s2d_early``) raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .models.bridge import load_flax_variables
from .models.feature_extractor import create_model_from_config
from .models.fused_backbone import FusedBackboneRunner
from .models.int8_tail import Int8TailRunner, calibrate_act_scales, default_tail_start
from .models.layers import init_weights
from .models.scrfd_int8 import ScrfdInt8Runner, calibrate_det_act_scales
from .ops.anchors import STRIDES, all_anchor_centers, decode_boxes, decode_landmarks
from .ops.image import normalize_imagenet
from .ops.quality import overall_quality
from .ops.umeyama import transform_points, umeyama
from .ops.warp import _avg_pool2, warp_affine_windowed
from .ops.warp_kernel import warp_affine_legacy
from .preprocessing.aligner import DEFAULT_REFERENCE_LANDMARKS, _LANDMARK_ORDER
from .preprocessing.detector import build_detection_net, default_weights_path
from .utils.msgpack import msgpack_restore

_NEXT_SLICE = ("the next slice of the port (multi-face serving, the uw/uw16/int8 tap modes, "
               "the lite detector and use_s2d_early)")


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet: it belongs to {_NEXT_SLICE}")


class FusedPipeline:
    """detect+align+quality+classify in one call.

    ``forward(frames)`` with frames (B, H, W, 3) RGB [0, 255] at serving
    size (uint8 preferred) returns a dict of per-frame tensors: every frame
    yields its best face with a validity flag. Weights come from
    ``init_variables`` (seeded) or ``load_variables`` (seeded, then the
    committed detector weights and an optional classifier checkpoint).

    ``use_int8_tail`` runs the backbone from block ``int8_tail_start``
    (default: ``default_tail_start``) through the s8 GEMM kernel and
    ``use_int8_detector`` the detector's wide convs through the s8 conv
    kernel; ``int8_act_scales``/``det_act_scales`` are calibrated static
    activation scales (None → dynamic per-image scales), set here or by
    ``calibrate_int8``/``calibrate_int8_detector``. ``use_fused_backbone``
    runs the stem and the early blocks (down to 14² maps) through the fused
    kernels in bf16 and resumes the stock backbone after them; unlike the
    JAX pipeline, which drops the option silently off the TPU, it holds on
    every device: on a CUDA device the kernels run or the call raises, on
    ``device="cpu"`` their plain versions run. The runners are built from
    the networks' weights by ``init_variables`` and ``load_variables``; call
    ``build_runners`` after changing the weights any other way.
    ``compute_quality=False`` skips quality scoring (quality 1, valid).
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
        int8_tail_start: Optional[int] = None,
        int8_act_scales: Optional[List[Dict[str, float]]] = None,
        use_s2d_early: bool = False,
        use_int8_detector: bool = False,
        det_act_scales: Optional[Dict[str, float]] = None,
        keep_top_k: int = 1,
        compute_quality: bool = True,
        detector_arch: str = "scrfd",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if use_int8_detector and detector_arch != "scrfd":
            raise ValueError("use_int8_detector supports the scrfd family only")
        if keep_top_k != 1:
            raise _not_ported("keep_top_k > 1 (multi-face serving with NMS)")
        if warp_tap_mode != "legacy":
            raise _not_ported(f"warp_tap_mode={warp_tap_mode!r}")
        if detector_arch != "scrfd":
            raise _not_ported(f"detector_arch={detector_arch!r}")
        if use_s2d_early:
            raise _not_ported("use_s2d_early")

        self.device = resolve_device(device)
        self.dtype = dtype
        self.input_size = tuple(detection_input_size)
        self.serving_size = tuple(serving_size or detection_input_size)
        self.output_size = tuple(output_size)
        self.warp_window = warp_window
        self.warp_fractional = warp_fractional
        self.confidence_threshold = confidence_threshold
        self.compute_quality = compute_quality
        self.use_fused_backbone = use_fused_backbone
        self.use_int8_tail = use_int8_tail
        self.int8_tail_start = int8_tail_start
        self.int8_act_scales = int8_act_scales
        self.use_int8_detector = use_int8_detector
        self.det_act_scales = det_act_scales
        self._tail: Optional[Int8TailRunner] = None
        self._det_int8: Optional[ScrfdInt8Runner] = None
        self._fused: Optional[FusedBackboneRunner] = None
        self._windowed = min(self.serving_size) > warp_window
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
        self.build_runners()
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
        self.build_runners()
        return self.detector, self.model

    # ------------------------------------------------------------------
    @property
    def _tail_start(self) -> int:
        if self.int8_tail_start is not None:
            return self.int8_tail_start
        return default_tail_start(self.model.variant)

    def build_runners(self) -> None:
        """(Re)build the fused-backbone and int8 runners from the networks'
        current weights and the stored activation scales: BatchNorm folding
        and weight quantization happen here, once, not in ``forward``."""
        if self.use_fused_backbone:
            self._fused = FusedBackboneRunner(self.model.feature_extractor.backbone,
                                              image_size=self.output_size[0])
        if self.use_int8_tail and not self.use_fused_backbone:  # the fused backbone wins
            self._tail = Int8TailRunner(self.model.feature_extractor.backbone,
                                        start_block=self._tail_start,
                                        act_scales=self.int8_act_scales)
        if self.use_int8_detector:
            self._det_int8 = ScrfdInt8Runner(self.detector, act_scales=self.det_act_scales,
                                             dtype=self.dtype)

    def calibrate_int8(self, faces, batch_size: int = 32) -> List[Dict[str, float]]:
        """Calibrate static int8 activation scales on aligned face crops.

        ``faces``: (N, *output_size, 3) RGB [0, 255], representative aligned
        faces. Stores the scales and rebuilds the tail runner with them.
        """
        if not self.use_int8_tail:
            raise ValueError("calibrate_int8 requires use_int8_tail=True")
        if not self._initialized:
            raise RuntimeError("call init_variables or load_variables before calibrate_int8")
        faces = torch.as_tensor(faces).to(self.device, torch.float32)
        norm = normalize_imagenet(faces / 255.0)
        self.int8_act_scales = calibrate_act_scales(
            self.model.feature_extractor.backbone,
            [norm[i:i + batch_size].to(self.dtype) for i in range(0, norm.shape[0], batch_size)],
            start_block=self._tail_start,
        )
        self.build_runners()
        return self.int8_act_scales

    def calibrate_int8_detector(self, frames, batch_size: int = 32) -> Dict[str, float]:
        """Calibrate static int8 activation scales for the detector.

        ``frames``: (N, *serving_size, 3) RGB [0, 255] representative
        serving frames; they go through the pooling and normalization the
        graph applies, so the calibration sees the canvas tensors of
        serving. Stores the scales and rebuilds the detector runner.
        """
        if not self.use_int8_detector:
            raise ValueError("calibrate_int8_detector requires use_int8_detector=True")
        if not self._initialized:
            raise RuntimeError("call init_variables or load_variables before "
                               "calibrate_int8_detector")
        x = self._canvas(torch.as_tensor(frames).to(self.device).to(self.dtype))
        self.det_act_scales = calibrate_det_act_scales(
            self.detector, [x[i:i + batch_size] for i in range(0, x.shape[0], batch_size)])
        self.build_runners()
        return self.det_act_scales

    def _canvas(self, frames: torch.Tensor) -> torch.Tensor:
        """Normalized detection canvas: pool down to stem_fold× the detection
        size (the final 2× rides the folded first conv), then (x−127.5)/128."""
        while frames.shape[1] > self.input_size[0] * self._stem_fold:
            frames = _avg_pool2(frames)
        return (frames - 127.5) / 128.0

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

        # 0–1. Detection canvas, detection network + decode; the best face
        #    is the argmax.
        outs = (self._det_int8 if self.use_int8_detector else self.detector)(self._canvas(frames))
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
                                           window=self.warp_window,
                                           fractional=self.warp_fractional)
        else:
            aligned = warp_affine_legacy(frames, tform, self.output_size)
        aligned_lms = transform_points(tform, lms)

        # 3. Quality scoring on the aligned face (skippable).
        if self.compute_quality:
            quality, q_valid, _ = overall_quality(aligned, aligned_lms, bbox, conf)
        else:
            quality = torch.ones_like(conf)
            q_valid = torch.ones_like(conf, dtype=torch.bool)

        # 4. Classification. The fused early stages and the int8 tail both
        #    work on NHWC in bf16 whatever the pipeline dtype; the stock
        #    backbone resumes after the one and the head conv, attention and
        #    classifier after the other.
        norm = normalize_imagenet(aligned / 255.0)
        if self.use_fused_backbone:
            x_tail = self._fused(norm).permute(0, 3, 1, 2)
            logits, features = self.model(x_tail, aligned_lms,
                                          backbone_start_block=self._fused.tail_start)
        elif self.use_int8_tail:
            backbone = self.model.feature_extractor.backbone
            split = backbone(norm, stop_block=self._tail.start, dtype=torch.bfloat16)
            maps = self._tail(split.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            logits, features = self.model(maps, aligned_lms,
                                          backbone_start_block=len(backbone.blocks))
        else:
            logits, features = self.model(norm, aligned_lms)
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
