"""Detector training: anchor assignment, the losses and the train step.

Counterpart of the JAX package's ``training/detection.py``, for the
anchor-head families (scrfd, mtcnn, lite):

- assignment, FCOS-style: an anchor is positive when its centre lies in a
  ground-truth box whose smaller side falls in the anchor's stride range
  (8: [0, 64), 16: [64, 128), 32: [128, ∞)), ties to the smallest box;
  ground truths are padded to ``max_faces`` with a validity mask;
- losses: sigmoid focal (normalized by the positives), 1 − IoU of the
  decoded boxes, Huber (δ = 1) on stride-normalized landmark offsets;
- ``make_detector_train_step``: forward in train mode (batch statistics,
  running statistics moved), backward, global-norm clip and the
  optimizer's step (``training/optim.py::clip_and_step``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import STRIDES, all_anchor_centers, decode_boxes, decode_landmarks
from .optim import clip_and_step

# Per-stride face-size ranges (min side, max side) for level assignment.
SCALE_RANGES = {8: (0.0, 64.0), 16: (64.0, 128.0), 32: (128.0, 1e9)}


def assign_targets(centers: torch.Tensor, strides: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_kps: torch.Tensor, gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-anchor targets. centers (N, 2), strides (N,); gt_boxes (..., G,
    4) xyxy, gt_kps (..., G, 5, 2), gt_valid (..., G) with any leading
    batch dims. Returns cls (..., N), box (..., N, 4), kps (..., N, 5, 2),
    pos (..., N)."""
    cx, cy = centers[:, 0], centers[:, 1]
    x1, y1, x2, y2 = gt_boxes.unbind(-1)  # (..., G)
    inside = ((cx[:, None] >= x1[..., None, :]) & (cx[:, None] <= x2[..., None, :])
              & (cy[:, None] >= y1[..., None, :]) & (cy[:, None] <= y2[..., None, :]))
    size = torch.minimum(x2 - x1, y2 - y1)
    ranges = [SCALE_RANGES[s] for s in STRIDES]
    lo = torch.tensor([r[0] for r in ranges], dtype=torch.float32, device=centers.device)
    hi = torch.tensor([r[1] for r in ranges], dtype=torch.float32, device=centers.device)
    level = torch.zeros_like(strides, dtype=torch.long)
    for i, s in enumerate(STRIDES):
        level = torch.where(strides == s, i, level)
    in_range = ((size[..., None, :] >= lo[level][:, None])
                & (size[..., None, :] < hi[level][:, None]))
    candidate = inside & in_range & gt_valid.bool()[..., None, :]  # (..., N, G)
    area = ((x2 - x1) * (y2 - y1)).clamp_min(1.0)
    score = torch.where(candidate, -area[..., None, :], -torch.inf)
    best_gt = score.argmax(dim=-1)  # (..., N), the first of equals
    pos = candidate.any(dim=-1)
    box_t = torch.gather(gt_boxes, -2, best_gt[..., None].expand(*best_gt.shape, 4))
    kps_t = torch.gather(gt_kps, -3, best_gt[..., None, None].expand(*best_gt.shape, 5, 2))
    return {"cls": pos.float(), "box": box_t, "kps": kps_t, "pos": pos}


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss on optax's sigmoid cross entropy."""
    p = torch.sigmoid(logits)
    ce = -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * (1 - p_t) ** gamma * ce


def huber_loss(errors: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax's ``huber_loss`` of the errors, elementwise."""
    abs_err = errors.abs()
    quadratic = torch.clamp_max(abs_err, delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


def iou_loss(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """1 − IoU, elementwise over matched xyxy pairs."""
    lt = torch.maximum(pred_boxes[..., :2], gt_boxes[..., :2])
    rb = torch.minimum(pred_boxes[..., 2:], gt_boxes[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = ((pred_boxes[..., 2] - pred_boxes[..., 0])
              * (pred_boxes[..., 3] - pred_boxes[..., 1])).clamp_min(0.0)
    area_g = ((gt_boxes[..., 2] - gt_boxes[..., 0])
              * (gt_boxes[..., 3] - gt_boxes[..., 1])).clamp_min(0.0)
    union = area_p + area_g - inter
    return 1.0 - inter / union.clamp_min(1e-9)


def detection_loss(outputs: Dict[int, Dict[str, torch.Tensor]], centers: torch.Tensor,
                   strides: torch.Tensor, gt_boxes: torch.Tensor, gt_kps: torch.Tensor,
                   gt_valid: torch.Tensor, box_weight: float = 2.0,
                   kps_weight: float = 0.5) -> Dict[str, torch.Tensor]:
    """Batched loss over the multi-level outputs; gt_boxes (B, G, 4),
    gt_kps (B, G, 5, 2), gt_valid (B, G)."""
    scores = torch.cat([outputs[s]["scores"] for s in STRIDES], dim=1)
    dist = torch.cat([outputs[s]["bbox"] for s in STRIDES], dim=1)
    kps = torch.cat([outputs[s]["kps"] for s in STRIDES], dim=1)
    targets = assign_targets(centers, strides, gt_boxes, gt_kps, gt_valid)
    pos = targets["pos"]
    n_pos = pos.sum().float().clamp_min(1.0)
    cls_loss = sigmoid_focal_loss(scores, targets["cls"]).sum() / n_pos
    box_l = iou_loss(decode_boxes(centers, strides, dist), targets["box"])
    box_loss = torch.where(pos, box_l, 0.0).sum() / n_pos
    kps_err = (decode_landmarks(centers, strides, kps) - targets["kps"]) / strides[None, :, None, None]
    kps_l = huber_loss(kps_err, 1.0).sum(dim=(-1, -2))
    kps_loss = torch.where(pos, kps_l, 0.0).sum() / n_pos
    total = cls_loss + box_weight * box_loss + kps_weight * kps_loss
    return {"total": total, "cls": cls_loss, "box": box_loss, "kps": kps_loss, "num_pos": n_pos}


def _as_tensors(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_detector_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                             input_size: Tuple[int, int]):
    """The train step of an anchor-head detector: ``step(batch)`` with
    batch {'image' (B, H, W, 3) raw RGB [0, 255], 'boxes' (B, G, 4), 'kps'
    (B, G, 5, 2), 'valid' (B, G)} (numpy or tensors) updates the model in
    place and returns the losses, detached."""
    device = next(model.parameters()).device
    centers_np, strides_np = all_anchor_centers(tuple(input_size))
    centers = torch.as_tensor(centers_np, device=device)
    strides = torch.as_tensor(strides_np, device=device)
    params = list(model.parameters())

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        b = _as_tensors(batch, device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        outputs = model((b["image"].float() - 127.5) / 128.0)
        losses = detection_loss(outputs, centers, strides, b["boxes"], b["kps"], b["valid"])
        losses["total"].backward()
        losses["grad_norm"] = clip_and_step(optimizer, params)  # before clipping
        return {k: v.detach() for k, v in losses.items()}

    return step


__all__ = ["SCALE_RANGES", "assign_targets", "detection_loss", "huber_loss", "iou_loss",
           "make_detector_train_step", "sigmoid_focal_loss"]
