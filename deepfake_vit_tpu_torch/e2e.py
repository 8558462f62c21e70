"""Fused end-to-end pipeline: detect → align → quality → classify per batch.

One call runs the SCRFD forward (its first conv folding the 2× pool from
serving to detection resolution), anchor decode, best-face selection,
Umeyama solve, the windowed warp (hand-written crop and warp kernels),
quality scoring, ImageNet normalization and the EfficientNet + attention
classifier — all on the pipeline's device, with static shapes and no host
round-trip between stages.

Ported: the best face per frame (``keep_top_k=1``) and multi-face serving
(``keep_top_k=K > 1``: the top-M anchors, fixed-size NMS at
``nms_threshold``, K faces per frame sharing its pixels through
``frame_idx``, outputs (B, K, …) with ``face_valid``); the pooled windowed
warp (the class default), the fractional one and, when the frame is no
larger than the window, the whole-frame warp, each with the tap modes
``legacy``, ``uw``, ``uw16`` and ``int8`` (``warp_tap_mode``); bf16 or
float32; the SCRFD detector family, in its own dtype or as the int8 graph
(``use_int8_detector``), the S2D-Lite family (``detector_arch="lite"``)
and MTCNN-Lite (``detector_arch="mtcnn"``, at serving_size ==
detection_input_size only: with a pool ratio of 2 or more the JAX class
folds the pool into an SCRFD stem it cannot build for this family, and
``build_detection_net`` raises a ``ValueError`` instead);
the int8 late-stage classifier tail (``use_int8_tail``) with
``calibrate_int8``/``calibrate_int8_detector``; the fused early backbone
stages (``use_fused_backbone``: stem and MBConv blocks through the fused
kernels, which wins over the int8 tail and the s2d stages when set, as in
the JAX graph); the space-to-depth early stages (``use_s2d_early``:
``models/s2d_early.py``, composing with the int8 tail);
``compute_quality=False``; the ViT classifier family (``model.type:
vit``) with the warp options, where the fused-backbone, int8-tail and s2d
options, which act on EfficientNet blocks, raise a ``ValueError`` (the
JAX class fails there on a missing ``batch_stats`` collection);
``make_sharded(mesh)``, the frame batch split over the mesh's devices in
one process, one replica of the pipeline a device.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .models.bridge import load_flax_variables
from .models.feature_extractor import create_model_from_config
from .models.fused_backbone import FusedBackboneRunner
from .models.int8_tail import Int8TailRunner, calibrate_act_scales, default_tail_start
from .models.layers import ensure_eval, init_weights
from .models.s2d_early import S2DEarlyRunner
from .models.scrfd_int8 import ScrfdInt8Runner, calibrate_det_act_scales
from .ops.anchors import STRIDES, all_anchor_centers, decode_boxes, decode_landmarks
from .ops.image import normalize_imagenet
from .ops.nms import nms_batched
from .ops.quality import overall_quality
from .ops.umeyama import transform_points, umeyama
from .ops.warp import _avg_pool2, warp_affine_auto, warp_affine_windowed
from .ops.warp_kernel import WARP_KERNELS
from .parallel.collectives import fixed_batch_max
from .preprocessing.aligner import DEFAULT_REFERENCE_LANDMARKS, _LANDMARK_ORDER
from .preprocessing.detector import build_detection_net, default_weights_path
from .utils.msgpack import msgpack_restore


class FusedPipeline:
    """detect+align+quality+classify in one call.

    ``forward(frames)`` with frames (B, H, W, 3) RGB [0, 255] at serving
    size (uint8 preferred) returns a dict of per-frame tensors: every frame
    yields its best face with a validity flag (K faces with ``keep_top_k``). Weights come from
    ``init_variables`` (seeded) or ``load_variables`` (seeded, then the
    committed detector weights and an optional classifier checkpoint).

    ``keep_top_k=K > 1`` serves up to K faces per frame: outputs gain a
    faces axis (B, K, …) and a ``face_valid`` mask (the NMS survivors above
    the confidence threshold). ``warp_tap_mode`` picks the warp kernel's
    taps ("legacy", "uw", "uw16", "int8"; see ``ops/warp.py``);
    ``detector_arch`` the detector family ("scrfd", "lite" or "mtcnn", each
    with its committed weights; "mtcnn" only at a pool ratio of 1).

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
    ``device="cpu"`` their plain versions run. ``use_s2d_early`` runs the
    stem and the blocks before the first stride-2 block after block 0 on a
    space-to-depth layout (``S2DEarlyRunner``), then the int8 tail from its
    start block if ``use_int8_tail``, else the stock backbone. The runners
    are built from the networks' weights by ``init_variables`` and
    ``load_variables``; call ``build_runners`` after changing the weights
    any other way.
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
        nms_threshold: float = 0.4,
        compute_quality: bool = True,
        detector_arch: str = "scrfd",
        device: Optional[Union[str, torch.device]] = None,
    ):
        if use_int8_detector and detector_arch != "scrfd":
            raise ValueError("use_int8_detector supports the scrfd family only")
        if warp_tap_mode not in WARP_KERNELS:
            raise ValueError(f"unknown warp_tap_mode {warp_tap_mode!r}; "
                             f"expected one of {sorted(WARP_KERNELS)}")
        if keep_top_k < 1:
            raise ValueError(f"keep_top_k must be at least 1, got {keep_top_k}")
        if model_config.get("model", {}).get("type") == "vit":
            blocks = [name for name, on in (("use_fused_backbone", use_fused_backbone),
                                            ("use_int8_tail", use_int8_tail),
                                            ("use_s2d_early", use_s2d_early)) if on]
            if blocks:
                raise ValueError(f"{', '.join(blocks)} act on EfficientNet blocks; "
                                 "a ViT classifier takes none of them")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.input_size = tuple(detection_input_size)
        self.serving_size = tuple(serving_size or detection_input_size)
        self.output_size = tuple(output_size)
        self.warp_window = warp_window
        self.warp_fractional = warp_fractional
        self.warp_tap_mode = warp_tap_mode
        self.keep_top_k = int(keep_top_k)
        self.nms_threshold = float(nms_threshold)
        self.detector_arch = detector_arch
        self.confidence_threshold = confidence_threshold
        self.compute_quality = compute_quality
        self.use_fused_backbone = use_fused_backbone
        self.use_int8_tail = use_int8_tail
        self.int8_tail_start = int8_tail_start
        self.int8_act_scales = int8_act_scales
        self.use_s2d_early = use_s2d_early
        self.use_int8_detector = use_int8_detector
        self.det_act_scales = det_act_scales
        self._tail: Optional[Int8TailRunner] = None
        self._det_int8: Optional[ScrfdInt8Runner] = None
        self._fused: Optional[FusedBackboneRunner] = None
        self._s2d: Optional[S2DEarlyRunner] = None
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

        ``detector_weights="default"`` loads the committed weights of the
        pipeline's detector family (None keeps the seeded init);
        ``classifier_checkpoint`` is a framework checkpoint (msgpack with
        ``params`` and, but for a ViT, ``batch_stats``).
        """
        self.init_variables(seed)
        if detector_weights == "default":
            detector_weights = default_weights_path(self.detector_arch)
        if classifier_checkpoint:
            ckpt = msgpack_restore(classifier_checkpoint)
            load_flax_variables(self.model, {"params": ckpt["params"],
                                             "batch_stats": ckpt.get("batch_stats", {})})
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
        """(Re)build the fused-backbone, s2d and int8 runners from the networks'
        current weights and the stored activation scales: BatchNorm folding
        and weight quantization happen here, once, not in ``forward``."""
        if self.use_fused_backbone:
            self._fused = FusedBackboneRunner(self.model.feature_extractor.backbone,
                                              image_size=self.output_size[0])
        else:  # the fused backbone wins over both
            if self.use_s2d_early:
                self._s2d = S2DEarlyRunner(self.model.feature_extractor.backbone,
                                           image_size=self.output_size[0])
            if self.use_int8_tail:
                self._tail = Int8TailRunner(self.model.feature_extractor.backbone,
                                            start_block=self._tail_start,
                                            act_scales=self.int8_act_scales)
        if self.use_int8_detector:
            self._det_int8 = ScrfdInt8Runner(self.detector, act_scales=self.det_act_scales,
                                             dtype=self.dtype)

    def calibrate_int8(self, faces, batch_size: int = 32) -> List[Dict[str, float]]:
        """Calibrate static int8 activation scales on aligned face crops.

        ``faces``: (N, *output_size, 3) RGB [0, 255], representative aligned
        faces. Stores the scales and rebuilds the tail runner with them. With
        ``use_s2d_early`` the tail's inputs come from the s2d stages, as in
        serving (the JAX pipeline calibrates on the stock stages either way).
        """
        if not self.use_int8_tail:
            raise ValueError("calibrate_int8 requires use_int8_tail=True")
        if not self._initialized:
            raise RuntimeError("call init_variables or load_variables before calibrate_int8")
        ensure_eval(self.model)
        faces = torch.as_tensor(faces).to(self.device, torch.float32)
        norm = normalize_imagenet(faces / 255.0)
        self.int8_act_scales = calibrate_act_scales(
            self.model.feature_extractor.backbone,
            [norm[i:i + batch_size].to(self.dtype) for i in range(0, norm.shape[0], batch_size)],
            start_block=self._tail_start, early=self._s2d,
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
        ensure_eval(self.detector)
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
        ensure_eval(self.detector, self.model)
        return self._graph(torch.as_tensor(frames).to(self.device))

    def _graph(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._classify(self._detect_align(frames))

    def _detect_align(self, frames: torch.Tensor) -> Dict[str, Any]:
        """Stages 0-3: detection, alignment, quality; the state stage 4 takes.
        Each stage is a method of its own (``profile_e2e`` times them one
        by one); composed here they are the graph's first half."""
        # Frame-side compute in the pipeline dtype: the warp quantizes
        # pixels to bf16 regardless.
        frames = frames.to(self.dtype)
        det = self._detect(self._canvas(frames))
        bbox, lms = self._to_serving(det["bbox"], det["landmarks"])
        aligned, aligned_lms = self._align(frames, lms, det["frame_idx"])
        quality, q_valid = self._quality(aligned, aligned_lms, bbox, det["confidence"])
        return {"B": frames.shape[0], "has_face": det["has_face"],
                "confidence": det["confidence"], "bbox": bbox, "aligned": aligned,
                "landmarks": aligned_lms, "quality": quality, "quality_valid": q_valid}

    def _detect(self, canvas: torch.Tensor, int8: Optional[bool] = None) -> Dict[str, Any]:
        """Stage 1: the detection network on the normalized canvas (the int8
        graph when ``use_int8_detector``, or as ``int8`` says), anchor
        decode and face selection, in canvas coordinates. One face per
        frame is the argmax; K faces are the NMS survivors of the top-M
        anchors, with ``frame_idx`` mapping each slot to its frame."""
        int8 = self.use_int8_detector if int8 is None else int8
        B, K = canvas.shape[0], self.keep_top_k
        outs = (self._det_int8 if int8 else self.detector)(canvas)
        scores = torch.cat([torch.sigmoid(outs[s]["scores"]) for s in STRIDES], dim=1)
        dist = torch.cat([outs[s]["bbox"] for s in STRIDES], dim=1)
        kps = torch.cat([outs[s]["kps"] for s in STRIDES], dim=1)
        boxes = decode_boxes(self._centers, self._strides, dist)
        landmarks = decode_landmarks(self._centers, self._strides, kps)
        rows = torch.arange(B, device=scores.device)
        frame_idx = None
        if K == 1:
            best = scores.argmax(dim=1)
            conf = scores[rows, best]
            bbox = boxes[rows, best]
            lms = landmarks[rows, best]
            has_face = conf >= self.confidence_threshold
        else:
            # Static top-M prefilter: NMS in O(K·M), not O(K·A). A stable
            # sort keeps the lower anchor first on tied scores, as
            # lax.top_k does.
            M = min(max(8 * K, 32), scores.shape[1])
            top_i = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :M]
            top_s = scores.gather(1, top_i)
            top_boxes = boxes[rows[:, None], top_i]
            top_lms = landmarks[rows[:, None], top_i]
            sel, valid = nms_batched(top_boxes.float(), top_s.float(),
                                     iou_threshold=self.nms_threshold, max_outputs=K)
            safe = sel.clamp_min(0)
            conf = top_s.gather(1, safe).reshape(B * K)
            bbox = top_boxes[rows[:, None], safe].reshape(B * K, 4)
            lms = top_lms[rows[:, None], safe].reshape(B * K, 5, 2)
            has_face = (valid.reshape(B * K) & (conf >= self.confidence_threshold))
            # The K faces of a frame share its pixels: no frame copies.
            frame_idx = rows.repeat_interleave(K)
        return {"confidence": conf, "bbox": bbox, "landmarks": lms, "has_face": has_face,
                "frame_idx": frame_idx}

    def _to_serving(self, bbox: torch.Tensor, lms: torch.Tensor):
        """Canvas → serving coords (pixel centers: u_s = r·u + (r−1)/2)."""
        r = self._pool_ratio
        if r > 1:
            shift = 0.5 * (r - 1)
            bbox = bbox * r + shift
            lms = lms * r + shift
        return bbox, lms

    def _align(self, frames: torch.Tensor, lms: torch.Tensor,
               frame_idx: Optional[torch.Tensor] = None):
        """Stage 2: batched Umeyama + warp from the serving frames (already
        in the pipeline dtype). Returns the aligned faces and landmarks."""
        tform = umeyama(lms, self.reference.expand(lms.shape))
        if self._windowed:
            aligned = warp_affine_windowed(frames, tform, self.output_size,
                                           window=self.warp_window, frame_indices=frame_idx,
                                           fractional=self.warp_fractional,
                                           tap_construction=self.warp_tap_mode)
        else:
            src = frames if frame_idx is None else frames[frame_idx]
            aligned = warp_affine_auto(src, tform, self.output_size,
                                       tap_construction=self.warp_tap_mode)
        return aligned, transform_points(tform, lms)

    def _quality(self, aligned: torch.Tensor, aligned_lms: torch.Tensor, bbox: torch.Tensor,
                 conf: torch.Tensor):
        """Stage 3: quality score and validity of each aligned face (quality
        1, valid, with ``compute_quality=False``)."""
        if self.compute_quality:
            quality, q_valid, _ = overall_quality(aligned, aligned_lms, bbox, conf)
            return quality, q_valid
        return torch.ones_like(conf), torch.ones_like(conf, dtype=torch.bool)

    def _classify(self, st: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Stage 4 and the outputs, from ``_detect_align``'s state."""
        B, K = st["B"], self.keep_top_k
        aligned, aligned_lms, has_face = st["aligned"], st["landmarks"], st["has_face"]

        # 4. Classification. The fused early stages and the int8 tail both
        #    work on NHWC in bf16 whatever the pipeline dtype; the stock
        #    backbone resumes after the one and the head conv, attention and
        #    classifier after the other.
        norm = normalize_imagenet(aligned / 255.0)
        if self.use_fused_backbone:
            x_tail = self._fused(norm).permute(0, 3, 1, 2)
            logits, features = self.model(x_tail, aligned_lms,
                                          backbone_start_block=self._fused.tail_start)
        elif self.use_int8_tail or self.use_s2d_early:
            backbone = self.model.feature_extractor.backbone
            x, start = norm, 0
            if self.use_s2d_early:
                x, start = self._s2d(norm), self._s2d.resume_block
            if self.use_int8_tail:
                split = backbone(x, start_block=start, stop_block=self._tail.start,
                                 dtype=torch.bfloat16)
                x = self._tail(split.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                start = len(backbone.blocks)
            logits, features = self.model(x, aligned_lms, backbone_start_block=start)
        else:
            logits, features = self.model(norm, aligned_lms)
        probs = torch.softmax(logits, dim=-1)
        out = {
            "has_face": has_face,
            "confidence": st["confidence"],
            "bbox": st["bbox"],
            "landmarks": aligned_lms,
            "quality": st["quality"],
            "quality_valid": st["quality_valid"],
            "probs": probs,
            "fake_prob": torch.where(has_face, probs[:, 1], torch.zeros_like(probs[:, 1])),
            "features": features,
        }
        if K > 1:
            # (B·K, …) → (B, K, …); the validity mask also under its config name.
            out = {k: v.reshape(B, K, *v.shape[1:]) for k, v in out.items()}
            out["face_valid"] = out["has_face"]
        return out

    # ------------------------------------------------------------------
    def _attention_max(self, st: Dict[str, Any]) -> Optional[torch.Tensor]:
        """The unnormalized landmark map's maximum over this batch's faces
        (what the classifier's ``global_max`` normalization divides by), or
        None for a classifier without landmark attention."""
        fe = getattr(self.model, "feature_extractor", None)
        attn = getattr(fe, "attention", None) if fe is not None else None
        if attn is None or not attn.use_landmark:
            return None
        size = fe.backbone.map_size(*self.output_size)
        return attn.landmark_attn.map_max(st["landmarks"], size, fe.backbone.dtype)

    def _replica(self, device: torch.device) -> "FusedPipeline":
        """A copy of the pipeline on ``device``: the networks' weights and
        the calibrated int8 scales copied, the runners built from them."""
        rep = copy.copy(self)
        rep.device = device
        rep.detector = copy.deepcopy(self.detector).to(device).eval()
        rep.model = copy.deepcopy(self.model).to(device).eval()
        rep._centers, rep._strides = self._centers.to(device), self._strides.to(device)
        rep.reference = self.reference.to(device)
        rep.int8_act_scales = copy.deepcopy(self.int8_act_scales)
        rep.det_act_scales = copy.deepcopy(self.det_act_scales)
        rep._tail = rep._det_int8 = rep._fused = rep._s2d = None
        rep.build_runners()
        return rep

    def make_sharded(self, mesh) -> Callable[[Any], Dict[str, torch.Tensor]]:
        """``fn(frames)`` serving the frame batch split over ``mesh``'s
        devices (``parallel.Mesh``; a device may repeat): one replica of
        the pipeline a device (``_replica``), the batch cut into contiguous
        stripes in device order (a batch that does not divide raises
        ``ValueError``, as JAX's sharding does), each stripe launched on
        its device's own stream with no host sync between the replicas,
        and the outputs concatenated in order on the first device (the
        keys of ``forward``). The classifier's landmark map is normalized
        by its maximum over the whole batch, as in ``forward`` and the JAX
        function's global arrays: the replicas' maxima are taken after
        their detection and alignment and shared on the devices, ordered
        by stream waits, before their classifiers run. A mesh of one
        device returns ``forward`` itself."""
        if mesh.size <= 1:
            return self.forward
        if mesh.distributed:
            raise ValueError("make_sharded splits a batch over this process's devices; "
                             "a mesh over several processes serves one stripe a process")
        if not self._initialized:
            raise RuntimeError("call init_variables or load_variables before make_sharded")
        ensure_eval(self.detector, self.model)
        devices = mesh.devices
        reps = [self._replica(d) for d in devices]
        cuda = all(d.type == "cuda" for d in devices)
        streams = [torch.cuda.Stream(d) for d in devices] if cuda else None

        def on(i: int):
            """Replica i's device and stream (nothing to select on the CPU)."""
            ctx = contextlib.ExitStack()
            if cuda:
                ctx.enter_context(torch.cuda.device(devices[i]))
                ctx.enter_context(torch.cuda.stream(streams[i]))
            return ctx

        @torch.inference_mode()
        def sharded(frames) -> Dict[str, torch.Tensor]:
            frames = torch.as_tensor(frames)
            n = len(reps)
            if frames.shape[0] % n:
                raise ValueError(f"a batch of {frames.shape[0]} frames does not split into "
                                 f"{n} equal stripes")
            k = frames.shape[0] // n
            if cuda:  # what the callers' streams queued comes first
                for i, d in enumerate(devices):
                    streams[i].wait_stream(torch.cuda.current_stream(d))
                    if frames.device.type == "cuda":
                        streams[i].wait_stream(torch.cuda.current_stream(frames.device))
            states, maxima = [], []
            for i, rep in enumerate(reps):
                with on(i):
                    stripe = frames[i * k:(i + 1) * k]
                    if cuda and stripe.device.type == "cuda":
                        stripe.record_stream(streams[i])
                    states.append(rep._detect_align(stripe.to(rep.device, non_blocking=True)))
                    maxima.append(rep._attention_max(states[-1]))
            shared = [None] * n
            if maxima[0] is not None:
                with on(0):
                    if cuda:
                        for s in streams[1:]:
                            streams[0].wait_stream(s)
                    top = torch.stack([m.to(devices[0]) for m in maxima]).max()
                for i in range(n):
                    with on(i):
                        if cuda and i:
                            streams[i].wait_stream(streams[0])
                        shared[i] = top.to(devices[i])
            outs = []
            for i, rep in enumerate(reps):
                with on(i), (fixed_batch_max(shared[i]) if shared[i] is not None
                             else contextlib.nullcontext()):
                    outs.append(rep._classify(states[i]))
            if cuda:
                main = torch.cuda.current_stream(devices[0])
                for s in streams:
                    main.wait_stream(s)
                for out in outs:
                    for t in out.values():
                        t.record_stream(main)
            return {key: torch.cat([out[key].to(devices[0]) for out in outs])
                    for key in outs[0]}

        return sharded

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
