"""Face detection front end: the detection networks, their committed
weights and the batched ``FaceDetector``.

Counterpart of ``deepfake_vit_tpu/preprocessing/detector.py``.
``FaceDetector.detect`` returns the best face as ``{bbox (4,), landmarks
(5, 2), confidence, num_faces}`` above a confidence threshold;
``batch_detect`` runs the detection network, anchor decode and fixed-size
NMS once for a whole batch on the detector's device, then picks each
frame's best face on the host. Frames of any size are letterboxed into the
static detection canvas on the device: an aspect-preserving bilinear
resize (``F.interpolate``, half-pixel centres, no antialiasing: the
sampling of ``cv2.resize(INTER_LINEAR)``, which works in 11-bit fixed
point and so differs by at most one grey level on uint8 frames), pasted
at the top left of a zero canvas.

The weights are the JAX package's in-framework-trained flax msgpack files,
read by path (``utils/msgpack.py``) and carried across by
``models/bridge.py``. Families: ``scrfd`` (alias ``retinaface``),
``lite``, ``mtcnn`` (MTCNN-Lite) and, through ``create_face_detector``,
``hog`` (alias ``dlib``; ``models/hog_detector.py``). ``refine=True``
appends the cascade's second stage (``models/refine_net.py``) to the
detect graph: the top ``refine_top_k`` proposals of each frame are cut
from the normalized frames, re-scored, regressed and re-landmarked, and
kept where the refined score reaches ``refine_threshold``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.bridge import load_flax_variables, to_numpy_tree
from ..models.layers import ensure_eval, init_weights
from ..models.lite_detector import LiteDetector
from ..models.mtcnn_lite import MtcnnLiteDetector
from ..models.refine_net import RefineNet, refine_detections
from ..models.scrfd import ScrfdDetector
from ..ops.anchors import STRIDES, all_anchor_centers, decode_boxes, decode_landmarks
from ..ops.nms import nms_batched
from ..utils.msgpack import msgpack_restore

_WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "deepfake_vit_tpu" / "weights"
DEFAULT_WEIGHTS_BY_MODEL = {"scrfd": _WEIGHTS_DIR / "scrfd_synface.msgpack",
                            "mtcnn": _WEIGHTS_DIR / "mtcnn_lite_synface.msgpack",
                            "hog": _WEIGHTS_DIR / "hog_synface.msgpack",
                            "lite": _WEIGHTS_DIR / "lite_synface.msgpack",
                            "refine": _WEIGHTS_DIR / "refine_synface.msgpack",
                            # Not a detector: the packaged classifier the predict CLI loads.
                            "classifier": _WEIGHTS_DIR / "classifier_synface.msgpack"}


def default_weights_path(model: str = "scrfd") -> Optional[str]:
    """Path to the committed weights of ``model``, or None if absent.

    ``DFV_WEIGHTS_<MODEL>`` (e.g. ``DFV_WEIGHTS_LITE``) overrides the
    committed path: a path that exists wins, one that does not gives None.
    The promotion gate (``promote_weights.py``) sets it so that every
    loader sees the staged candidate while the family's bars run."""
    env = os.environ.get(f"DFV_WEIGHTS_{model.upper()}")
    if env:
        return env if Path(env).exists() else None
    p = DEFAULT_WEIGHTS_BY_MODEL.get(model)
    return str(p) if p is not None and p.exists() else None


def build_detection_net(model: str = "scrfd", dtype: torch.dtype = torch.float32,
                        stem_pool: int = 1) -> Union[ScrfdDetector, LiteDetector, MtcnnLiteDetector]:
    """Detection net factory: 'scrfd' (alias 'retinaface'), 'lite' and
    'mtcnn'. ``stem_pool=p`` builds the network that takes p·canvas frames
    and folds the p× average pool into its first conv (scrfd and lite;
    the JAX package has no folded MTCNN-Lite stem either)."""
    if model in ("scrfd", "retinaface"):
        return ScrfdDetector(dtype=dtype, stem_pool=stem_pool)
    if model == "lite":
        return LiteDetector(dtype=dtype, stem_pool=stem_pool)
    if model == "mtcnn":
        if stem_pool != 1:
            raise ValueError(f"the mtcnn family has no pooled stem (stem_pool={stem_pool}): "
                             "serve it at serving_size == detection_input_size")
        return MtcnnLiteDetector(dtype=dtype)
    raise ValueError(f"unknown detector model: {model}")


def letterbox(image, input_size: Tuple[int, int], device) -> Tuple[torch.Tensor, float]:
    """Aspect-preserving resize of one (h, w, 3) RGB frame into the
    (H, W, 3) canvas ``input_size``, on ``device``: the frame's top left
    corner at the canvas's, zeros elsewhere. uint8 frames stay uint8
    (rounded and clamped), others become float32. Returns (canvas, scale)."""
    H, W = input_size
    img = torch.as_tensor(np.asarray(image)).to(device)
    h, w = img.shape[:2]
    scale = min(W / w, H / h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    u8 = img.dtype == torch.uint8
    if (nh, nw) == (h, w):
        resized = img if u8 else img.float()
    else:
        x = img.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=False)[0].permute(1, 2, 0)
        resized = torch.round(x).clamp(0, 255).to(torch.uint8) if u8 else x
    canvas = torch.zeros((H, W, 3), dtype=resized.dtype, device=device)
    canvas[:nh, :nw] = resized
    return canvas, scale


class FaceDetector:
    """Detection network + batched decode and NMS on one device."""

    def __init__(
        self,
        confidence_threshold: float = 0.5,
        nms_threshold: float = 0.4,
        keep_top_k: int = 1,
        input_size: Tuple[int, int] = (640, 640),
        max_detections: int = 64,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        pretrained: bool = True,
        model_name: str = "scrfd",
        refine: bool = False,
        refine_threshold: float = 0.7,
        refine_top_k: int = 4,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.confidence_threshold = confidence_threshold
        self.nms_threshold = nms_threshold
        self.keep_top_k = keep_top_k
        self.input_size = tuple(input_size)
        self.max_detections = max_detections
        self.model_name = model_name
        self.device = resolve_device(device)
        self.model = init_weights(build_detection_net(model_name), seed).to(self.device).eval()
        if params is not None:
            load_flax_variables(self.model, to_numpy_tree(params))
        elif pretrained and default_weights_path(model_name):
            self.load_weights(default_weights_path(model_name))
        self.refiner: Optional[RefineNet] = None
        self.refine_threshold = refine_threshold
        self.refine_top_k = refine_top_k
        if refine:
            self.refiner = init_weights(RefineNet(), seed + 1).to(self.device).eval()
            if pretrained and default_weights_path("refine"):
                self.load_refiner_weights(default_weights_path("refine"))
        centers, strides = all_anchor_centers(self.input_size)
        self._centers = torch.as_tensor(centers, device=self.device)
        self._strides = torch.as_tensor(strides, device=self.device)

    # -- device graph -------------------------------------------------------
    @torch.inference_mode()
    def _detect_graph(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) uint8/float raw RGB [0, 255] on the device.
        Returns the padded detections: boxes (B, K, 4), scores (B, K) (0
        where invalid), landmarks (B, K, 5, 2), valid (B, K)."""
        ensure_eval(self.model)
        x = (images.float() - 127.5) / 128.0
        outs = self.model(x)
        scores = torch.cat([torch.sigmoid(outs[s]["scores"]) for s in STRIDES], dim=1)
        dist = torch.cat([outs[s]["bbox"] for s in STRIDES], dim=1)
        kps = torch.cat([outs[s]["kps"] for s in STRIDES], dim=1)
        boxes = decode_boxes(self._centers, self._strides, dist)
        landmarks = decode_landmarks(self._centers, self._strides, kps)
        idx, valid = nms_batched(boxes, scores, iou_threshold=self.nms_threshold,
                                 score_threshold=self.confidence_threshold,
                                 max_outputs=self.max_detections)
        safe = idx.clamp_min(0)
        rows = torch.arange(boxes.shape[0], device=boxes.device)[:, None]
        sel_scores = scores.gather(1, safe)
        dets = {"boxes": boxes[rows, safe], "scores": torch.where(valid, sel_scores, 0.0),
                "landmarks": landmarks[rows, safe], "valid": valid}
        if self.refiner is not None:
            ensure_eval(self.refiner)
            dets = refine_detections(self.refiner, x, dets, top_k=self.refine_top_k,
                                     refine_threshold=self.refine_threshold)
        return dets

    # -- host API -----------------------------------------------------------
    def detect_batch_raw(self, images) -> Dict[str, np.ndarray]:
        """Batched detection on pre-sized (B, H, W, 3) RGB uint8/float frames
        (host arrays or tensors); the padded detections as numpy arrays."""
        images = torch.as_tensor(images).to(self.device)
        return {k: v.cpu().numpy() for k, v in self._detect_graph(images).items()}

    def detect(self, image: np.ndarray) -> Optional[Dict[str, Any]]:
        """Single RGB image → best face dict or None."""
        return self.batch_detect([image])[0]

    def batch_detect(self, images: Sequence[np.ndarray]) -> List[Optional[Dict[str, Any]]]:
        canvases, scales = zip(*(letterbox(img, self.input_size, self.device) for img in images))
        dtypes = {c.dtype for c in canvases}
        batch = torch.stack([c.float() for c in canvases] if len(dtypes) > 1 else canvases)
        return self._postprocess(self.detect_batch_raw(batch), scales)

    def batch_detect_device(self, images: torch.Tensor) -> List[Optional[Dict[str, Any]]]:
        """Detection on a (B, H, W, 3) tensor whose spatial shape equals
        ``input_size`` (no letterbox, scale 1), so that callers can share
        one host → device copy between detection and the later stages."""
        if tuple(images.shape[1:3]) != self.input_size:
            raise ValueError(f"device batch {tuple(images.shape[1:3])} != input_size "
                             f"{self.input_size}")
        return self._postprocess(self.detect_batch_raw(images), (1.0,) * images.shape[0])

    def _postprocess(self, out: Dict[str, np.ndarray], scales) -> List[Optional[Dict[str, Any]]]:
        results: List[Optional[Dict[str, Any]]] = []
        for b, scale in enumerate(scales):
            valid = out["valid"][b]
            n = int(valid.sum())
            if n == 0:
                results.append(None)
                continue
            scores = out["scores"][b][valid]
            best = np.argsort(-scores)[: self.keep_top_k][0]
            boxes = out["boxes"][b][valid] / scale
            lms = out["landmarks"][b][valid] / scale
            results.append({"bbox": boxes[best].astype(np.float32),
                            "landmarks": lms[best].astype(np.float32),
                            "confidence": float(scores[best]), "num_faces": n})
        return results

    def load_weights(self, path: str) -> None:
        """Load detector weights from a flax msgpack state dict."""
        load_flax_variables(self.model, msgpack_restore(path))

    def load_refiner_weights(self, path: str) -> None:
        """Load the cascade stage's (RefineNet) weights; needs refine=True."""
        if self.refiner is None:
            raise ValueError("detector built without refine=True")
        load_flax_variables(self.refiner, msgpack_restore(path))

    @staticmethod
    def get_face_roi(image: np.ndarray, bbox: np.ndarray, margin: float = 0.2) -> np.ndarray:
        """Margin-expanded crop of ``image`` around ``bbox`` (x1, y1, x2, y2)."""
        h, w = image.shape[:2]
        x1, y1, x2, y2 = bbox
        mw = (x2 - x1) * margin
        mh = (y2 - y1) * margin
        x1 = int(max(0, x1 - mw))
        y1 = int(max(0, y1 - mh))
        x2 = int(min(w, x2 + mw))
        y2 = int(min(h, y2 + mh))
        return image[y1:y2, x1:x2]


class ScrfdFaceDetector(FaceDetector):
    """Named alias for the production path (the SCRFD family)."""


def create_face_detector(config: Dict[str, Any],
                         device: Optional[Union[str, torch.device]] = None) -> FaceDetector:
    """Factory from the preprocessing config's 'detection' block."""
    model = config.get("model", "scrfd")
    scrfd_cfg = config.get("scrfd", {}) or {}
    kwargs = dict(
        confidence_threshold=config.get("confidence_threshold", 0.5),
        nms_threshold=config.get("nms_threshold", 0.4),
        keep_top_k=config.get("keep_top_k", 1),
        input_size=tuple(scrfd_cfg.get("input_size", (640, 640))),
        max_detections=scrfd_cfg.get("max_detections", 64),
        refine=bool(config.get("refine", False)),
        refine_threshold=config.get("refine_threshold", 0.7),
        refine_top_k=config.get("refine_top_k", 4),
        device=device,
    )
    if model in ("scrfd", "retinaface"):
        det = ScrfdFaceDetector(**kwargs)
    elif model in ("lite", "mtcnn"):
        det = FaceDetector(model_name=model, **kwargs)
    elif model in ("hog", "dlib"):
        from ..models.hog_detector import HogFaceDetector

        det = HogFaceDetector(confidence_threshold=kwargs["confidence_threshold"],
                              nms_threshold=kwargs["nms_threshold"],
                              keep_top_k=kwargs["keep_top_k"], input_size=kwargs["input_size"],
                              upsample=int(config.get("upsample", 1)), device=device)
    else:
        raise ValueError(f"unknown detector model: {model}")
    path = scrfd_cfg.get("pretrained_path")
    if path:
        det.load_weights(path)
    return det


__all__ = ["DEFAULT_WEIGHTS_BY_MODEL", "FaceDetector", "ScrfdFaceDetector", "build_detection_net",
           "create_face_detector", "default_weights_path", "letterbox"]
