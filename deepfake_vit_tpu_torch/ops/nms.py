"""Fixed-size greedy NMS on the pipeline's device.

Static output size, as the JAX package's ``ops/nms.py``: selection runs a
fixed ``max_outputs`` steps over the whole batch at once (O(K·N), K small),
each step taking the highest live score (the lower index on ties, as
``argmax`` does in both frameworks) and suppressing every box whose IoU
with it exceeds the threshold; outputs are padded with index −1 and
``valid=False``. Plain PyTorch: the JAX version is a ``lax.scan`` of XLA
ops, not a kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) × (..., M, 4) → (..., N, M)."""
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]).clamp_min(0) * (
        boxes_a[..., 3] - boxes_a[..., 1]).clamp_min(0)
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]).clamp_min(0) * (
        boxes_b[..., 3] - boxes_b[..., 1]).clamp_min(0)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms_batched(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.4,
                score_threshold: float = 0.0,
                max_outputs: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per batch row: boxes (B, N, 4), scores (B, N) → indices
    (B, K) int64, padded with −1, and valid (B, K) bool."""
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    live = scores > score_threshold
    neg_inf = torch.full_like(scores, float("-inf"))
    indices, valid = [], []
    for _ in range(max_outputs):
        masked = torch.where(live, scores, neg_inf)
        idx = masked.argmax(dim=1)
        ok = masked[rows, idx] > float("-inf")
        ious = iou_matrix(boxes[rows, idx][:, None, :], boxes)[:, 0]
        new_live = live & (ious <= iou_threshold)
        new_live[rows, idx] = False
        live = torch.where(ok[:, None], new_live, live)
        indices.append(torch.where(ok, idx, torch.full_like(idx, -1)))
        valid.append(ok)
    return torch.stack(indices, 1), torch.stack(valid, 1)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.4,
        score_threshold: float = 0.0,
        max_outputs: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of one image: boxes (N, 4), scores (N,) → indices (K,),
    padded with −1, and valid (K,)."""
    idx, ok = nms_batched(boxes[None], scores[None], iou_threshold, score_threshold, max_outputs)
    return idx[0], ok[0]


__all__ = ["iou_matrix", "nms", "nms_batched"]
