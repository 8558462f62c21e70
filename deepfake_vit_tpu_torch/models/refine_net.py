"""RefineNet: the cascade's second stage, which re-scores, regresses and
re-landmarks the detector's top proposals.

Counterpart of the JAX package's ``models/refine_net.py``. The top-K slots
of the detector's padded NMS output are expanded to margin-padded squares
(``square_boxes``), cut from the normalized frames as 64² crops by the
exact float32 warp (``ops/warp.py::crop_and_resize``, a gather as in the
JAX package, not the bf16 warp kernel whose taps would change the
refiner's inputs), and scored by one forward over (B·K, 64, 64, 3):
a sigmoid score, box deltas in units of the square's side
(``apply_box_deltas``) and landmarks in [0, 1] square coordinates
(``decode_refined_kps``). A refined slot stays valid when its refined
score reaches ``refine_threshold``; slots past K pass through.

``RefineNet``'s submodules carry the flax keys (``conv0``-``conv3``,
``bn0``-``bn3``, ``fc``, ``cls``, ``box``, ``kps``), so
``models/bridge.py`` loads ``refine_synface.msgpack``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.warp import crop_and_resize
from .layers import BatchNorm, Conv, Dense

REFINE_CROP = 64  # the crop side


class RefineNet(nn.Module):
    """(N, S, S, 3) normalized crops → {'score' (N,), 'box' (N, 4),
    'kps' (N, 10)}: four 3×3 stride-2 conv + BN (momentum 0.9) + ReLU
    stages, flattened in NHWC order, a 128-wide dense layer + ReLU, and
    three dense heads."""

    def __init__(self, widths: Sequence[int] = (32, 64, 96, 128), dense: int = 128,
                 crop: int = REFINE_CROP, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, w in enumerate(widths):
            self.add_module(f"conv{i}", Conv(cin, w, 3, 2))
            self.add_module(f"bn{i}", BatchNorm(w, 1e-5, 0.9))
            cin = w
        self.n = len(widths)
        side = crop // 2 ** len(widths)
        self.fc = Dense(side * side * cin, dense)
        self.cls = Dense(dense, 1)
        self.box = Dense(dense, 4)
        self.kps = Dense(dense, 10)

    def forward(self, crops: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = crops.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(self.n):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax flattens NHWC
        x = F.relu(self.fc(x))
        wide = torch.promote_types(x.dtype, torch.float32)  # float64 stays
        return {"score": self.cls(x)[:, 0].to(wide), "box": self.box(x).to(wide),
                "kps": self.kps(x).to(wide)}


def square_boxes(boxes: torch.Tensor, margin: float = 0.15) -> torch.Tensor:
    """xyxy boxes (..., 4) → squares on the same centre with side
    max(w, h)·(1 + 2·margin), at least 1."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    side = torch.maximum(x2 - x1, y2 - y1) * (1.0 + 2.0 * margin)
    side = side.clamp_min(1.0)
    h = side * 0.5
    return torch.stack([cx - h, cy - h, cx + h, cy + h], dim=-1)


def apply_box_deltas(sq_boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Corners moved by delta · the square's side."""
    side = sq_boxes[..., 2] - sq_boxes[..., 0]
    return sq_boxes + deltas * side[..., None]


def decode_refined_kps(sq_boxes: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """kps (..., 10) in [0, 1] square coordinates → (..., 5, 2) pixels."""
    side = sq_boxes[..., 2] - sq_boxes[..., 0]
    pts = kps.reshape(*kps.shape[:-1], 5, 2)
    return sq_boxes[..., :2][..., None, :] + pts * side[..., None, None]


def refine_crops(images_norm: torch.Tensor, sq: torch.Tensor,
                 crop_size: int = REFINE_CROP) -> torch.Tensor:
    """(B, H, W, 3) frames and (B, K, 4) squares → (B·K, S, S, 3) crops,
    each frame read in place by its K boxes."""
    B, K = sq.shape[:2]
    fidx = torch.arange(B, device=sq.device).repeat_interleave(K)
    return crop_and_resize(images_norm, sq.reshape(B * K, 4), (crop_size, crop_size),
                           frame_idx=fidx)


def refine_detections(refiner: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                      images_norm: torch.Tensor, dets: Dict[str, torch.Tensor], top_k: int,
                      refine_threshold: float = 0.7, crop_size: int = REFINE_CROP,
                      margin: float = 0.15) -> Dict[str, torch.Tensor]:
    """Refine the top-K slots of the padded NMS output in place.

    ``images_norm``: the (B, H, W, 3) normalized frames the proposal net
    saw; ``dets``: {'boxes' (B, D, 4), 'scores' (B, D), 'landmarks'
    (B, D, 5, 2), 'valid' (B, D)}, slots sorted by score. Refined slots
    take the refiner's sigmoid score, regressed box and landmarks, and
    stay valid only where that score reaches ``refine_threshold``.
    """
    B, D = dets["scores"].shape
    K = min(top_k, D)
    sq = square_boxes(dets["boxes"][:, :K], margin)
    out = refiner(refine_crops(images_norm, sq, crop_size))
    r_score = torch.sigmoid(out["score"]).reshape(B, K)
    r_box = apply_box_deltas(sq, out["box"].reshape(B, K, 4))
    r_kps = decode_refined_kps(sq, out["kps"].reshape(B, K, 10))
    keep = dets["valid"][:, :K] & (r_score >= refine_threshold)
    return {
        "boxes": torch.cat([torch.where(keep[..., None], r_box, dets["boxes"][:, :K]),
                            dets["boxes"][:, K:]], dim=1),
        "scores": torch.cat([torch.where(keep, r_score, 0.0), dets["scores"][:, K:]], dim=1),
        "landmarks": torch.cat([torch.where(keep[..., None, None], r_kps,
                                            dets["landmarks"][:, :K]),
                                dets["landmarks"][:, K:]], dim=1),
        "valid": torch.cat([keep, dets["valid"][:, K:]], dim=1),
    }


__all__ = ["REFINE_CROP", "RefineNet", "apply_box_deltas", "decode_refined_kps",
           "refine_crops", "refine_detections", "square_boxes"]
