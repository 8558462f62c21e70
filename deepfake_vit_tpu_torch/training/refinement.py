"""Refiner (cascade stage two) training: crop sampling, losses and step.

Counterpart of the JAX package's ``training/refinement.py``. MTCNN's
online sampling with static shapes: each image contributes a fixed K
crop slots a step, each a jittered ground-truth box (a positive
candidate) or a random or far-shifted square (a negative one), labelled
by its IoU with the ground truth: at least ``POS_IOU`` a face (cls 1, box
and landmark regression), below ``NEG_IOU`` not a face (cls 0), between
the two a part face (no cls signal, box regression only). Targets are in
units of the margin-expanded square (``models/refine_net.py``), the crop
the serving cascade cuts. ``sample_refine_targets`` is numpy and draws
what the JAX function draws from the same ``rng``; the crops are cut in
the train step by the same ``crop_and_resize`` the cascade serves with.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.refine_net import REFINE_CROP, refine_crops
from .detection import _as_tensors, huber_loss
from .optim import clip_and_step

POS_IOU = 0.55
NEG_IOU = 0.30


def _square_np(box: np.ndarray, margin: float) -> np.ndarray:
    """Numpy twin of models.refine_net.square_boxes for the host sampler
    (kept bit-identical: center square, side = max(w,h)·(1+2·margin))."""
    cx, cy = (box[0] + box[2]) * 0.5, (box[1] + box[3]) * 0.5
    side = max(max(box[2] - box[0], box[3] - box[1]) * (1.0 + 2.0 * margin), 1.0)
    h = side * 0.5
    return np.array([cx - h, cy - h, cx + h, cy + h], np.float32)


def _iou_one(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """box (4,) vs gts (G,4) → (G,) IoU (numpy, host-side sampler)."""
    lt = np.maximum(box[:2], gts[:, :2])
    rb = np.minimum(box[2:], gts[:, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[:, 0] * wh[:, 1]
    a = max((box[2] - box[0]) * (box[3] - box[1]), 0.0)
    ag = np.maximum(gts[:, 2] - gts[:, 0], 0.0) * np.maximum(gts[:, 3] - gts[:, 1], 0.0)
    return inter / np.maximum(a + ag - inter, 1e-9)


def sample_refine_targets(
    det_batch: Dict[str, np.ndarray],
    rng: np.random.Generator,
    crops_per_image: int = 8,
    margin: float = 0.15,
) -> Dict[str, np.ndarray]:
    """Detection batch {'image','boxes','kps','valid'} → refiner batch.

    Returns {'image' (B,H,W,3) [shared], 'crop_boxes' (B,K,4) margin-
    expanded squares, 'cls' (B,K), 'cls_mask' (B,K), 'box_t' (B,K,4),
    'box_mask' (B,K), 'kps_t' (B,K,10), 'kps_mask' (B,K)}.
    """
    images = det_batch["image"]
    B = images.shape[0]
    H, W = images.shape[1], images.shape[2]
    K = crops_per_image

    crop_boxes = np.zeros((B, K, 4), np.float32)
    cls = np.zeros((B, K), np.float32)
    cls_mask = np.ones((B, K), np.float32)
    box_t = np.zeros((B, K, 4), np.float32)
    box_mask = np.zeros((B, K), np.float32)
    kps_t = np.zeros((B, K, 10), np.float32)
    kps_mask = np.zeros((B, K), np.float32)

    for b in range(B):
        valid = det_batch["valid"][b].astype(bool)
        gts = det_batch["boxes"][b][valid]  # (G, 4)
        gkps = det_batch["kps"][b][valid]  # (G, 5, 2)
        G = len(gts)
        for k in range(K):
            proposal = None
            if G and rng.uniform() < 0.7:
                # positive candidate: jittered GT
                g = rng.integers(G)
                x1, y1, x2, y2 = gts[g]
                w, h = max(x2 - x1, 2.0), max(y2 - y1, 2.0)
                s = rng.uniform(0.8, 1.25)
                dx = rng.uniform(-0.2, 0.2) * w
                dy = rng.uniform(-0.2, 0.2) * h
                cx, cy = (x1 + x2) / 2 + dx, (y1 + y2) / 2 + dy
                nw, nh = w * s, h * s
                proposal = np.array(
                    [cx - nw / 2, cy - nh / 2, cx + nw / 2, cy + nh / 2], np.float32
                )
            else:
                # negative candidate: random square, or far-shifted GT
                if G and rng.uniform() < 0.5:
                    g = rng.integers(G)
                    x1, y1, x2, y2 = gts[g]
                    side = max(x2 - x1, y2 - y1, 8.0)
                    shift = rng.uniform(0.6, 1.4) * side
                    ang = rng.uniform(0, 2 * np.pi)
                    cx = (x1 + x2) / 2 + shift * np.cos(ang)
                    cy = (y1 + y2) / 2 + shift * np.sin(ang)
                else:
                    side = rng.uniform(0.1, 0.5) * min(H, W)
                    cx = rng.uniform(side / 2, W - side / 2)
                    cy = rng.uniform(side / 2, H - side / 2)
                proposal = np.array(
                    [cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2],
                    np.float32,
                )

            iou = _iou_one(proposal, gts) if G else np.zeros((1,), np.float32)
            best = int(np.argmax(iou)) if G else 0
            best_iou = float(iou[best]) if G else 0.0

            sq = _square_np(proposal, margin)
            side = sq[2] - sq[0]
            crop_boxes[b, k] = sq

            if best_iou >= POS_IOU:
                cls[b, k] = 1.0
                gx = gts[best]
                # Corner-relative MTCNN encoding: x1' = sq_x1 + d·side etc.,
                # the exact inverse of refine_net.apply_box_deltas.
                box_t[b, k] = (gx - sq) / side
                box_mask[b, k] = 1.0
                kps_t[b, k] = (
                    (gkps[best] - sq[:2][None]) / side
                ).reshape(10)
                kps_mask[b, k] = 1.0
            elif best_iou < NEG_IOU:
                cls[b, k] = 0.0
            else:
                # part face: no cls signal, box regression only
                cls_mask[b, k] = 0.0
                gx = gts[best]
                box_t[b, k] = (gx - sq) / side
                box_mask[b, k] = 1.0

    return {
        "image": images,
        "crop_boxes": crop_boxes,
        "cls": cls,
        "cls_mask": cls_mask,
        "box_t": box_t,
        "box_mask": box_mask,
        "kps_t": kps_t,
        "kps_mask": kps_mask,
    }


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def refinement_loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                    box_weight: float = 1.0, kps_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """Masked BCE and Huber losses over the flattened (B·K,) outputs."""
    cls_t = batch["cls"].reshape(-1)
    cls_m = batch["cls_mask"].reshape(-1)
    n_cls = cls_m.sum().clamp_min(1.0)
    cls_loss = (_sigmoid_bce(out["score"], cls_t) * cls_m).sum() / n_cls
    box_m = batch["box_mask"].reshape(-1)
    n_box = box_m.sum().clamp_min(1.0)
    box_err = huber_loss(out["box"] - batch["box_t"].reshape(-1, 4), 1.0)
    box_loss = (box_err.sum(-1) * box_m).sum() / n_box
    kps_m = batch["kps_mask"].reshape(-1)
    n_kps = kps_m.sum().clamp_min(1.0)
    kps_err = huber_loss(out["kps"] - batch["kps_t"].reshape(-1, 10), 1.0)
    kps_loss = (kps_err.sum(-1) * kps_m).sum() / n_kps
    total = cls_loss + box_weight * box_loss + kps_weight * kps_loss
    return {"total": total, "cls": cls_loss, "box": box_loss, "kps": kps_loss}


def make_refiner_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                            crop_size: int = REFINE_CROP, kps_weight: float = 2.0):
    """The refiner's train step: ``step(batch)`` with a batch from
    ``sample_refine_targets`` cuts the (B·K) crops from the normalized
    frames, runs the refiner in train mode, backpropagates, clips and
    steps; returns the losses (and ``num_pos``), detached. ``kps_weight``
    2 tilts the trunk toward the landmark head."""
    device = next(model.parameters()).device
    params = list(model.parameters())

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        b = _as_tensors(batch, device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x = (b["image"].float() - 127.5) / 128.0
        out = model(refine_crops(x, b["crop_boxes"].float(), crop_size))
        losses = refinement_loss(out, b, kps_weight=kps_weight)
        losses["num_pos"] = (b["cls"] * b["cls_mask"]).sum()
        losses["total"].backward()
        losses["grad_norm"] = clip_and_step(optimizer, params)  # before clipping
        return {k: v.detach() for k, v in losses.items()}

    return step


__all__ = ["NEG_IOU", "POS_IOU", "make_refiner_train_step", "refinement_loss",
           "sample_refine_targets"]
