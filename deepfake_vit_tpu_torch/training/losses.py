"""Loss functions of the training step, on torch tensors.

Counterpart of the JAX package's ``training/losses.py``, function for
function and with its reductions (means over the batch):

- cross_entropy_loss: softmax CE; with class weights the mean is
  weight-normalized (Σ w·nll / (Σ w + 1e-12)).
- focal_loss: (1 − p_t)^γ · CE, optional per-class α.
- contrastive_loss: euclidean (``F.pairwise_distance`` semantics, eps
  1e-6 added to the difference) or cosine distance;
  ``same·d² + (1 − same)·relu(margin − d)²``, label 1 = same class.
- triplet_loss: relu(d_pos − d_neg + margin).
- label_smoothing_loss: one-hot smoothed CE.
- combined_loss: weighted CE + focal + contrastive, the contrastive pairs
  being adjacent even/odd samples of the batch.
- make_criterion: the config's ``training.loss`` block to
  ``criterion(logits, labels, features) -> dict`` with at least 'total'.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       reduction: str = "mean") -> torch.Tensor:
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    if class_weights is not None:
        w = class_weights[labels.long()]
        nll = nll * w
        if reduction == "mean":
            return nll.sum() / (w.sum() + 1e-12)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[torch.Tensor] = None, reduction: str = "mean") -> torch.Tensor:
    ce = cross_entropy_loss(logits, labels, reduction="none")
    pt = torch.exp(-ce)
    fl = (1.0 - pt) ** gamma * ce
    if alpha is not None:
        fl = alpha[labels.long()] * fl
    if reduction == "mean":
        return fl.mean()
    if reduction == "sum":
        return fl.sum()
    return fl


def _pairwise_distance(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.sqrt(((a - b + eps) ** 2).sum(-1))


def _cosine_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    cos = (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1) + 1e-8)
    return 1.0 - cos


def contrastive_loss(emb1: torch.Tensor, emb2: torch.Tensor, pair_labels: torch.Tensor,
                     margin: float = 1.0, distance: str = "euclidean") -> torch.Tensor:
    """pair_labels: 1.0 = same class (pull together), 0.0 = different (push)."""
    d = _pairwise_distance(emb1, emb2) if distance == "euclidean" else _cosine_distance(emb1, emb2)
    loss_same = pair_labels * d ** 2
    loss_diff = (1.0 - pair_labels) * F.relu(margin - d) ** 2
    return (loss_same + loss_diff).mean()


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 1.0, distance: str = "euclidean") -> torch.Tensor:
    dist = _pairwise_distance if distance == "euclidean" else _cosine_distance
    return F.relu(dist(anchor, positive) - dist(anchor, negative) + margin).mean()


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int = 2,
                         smoothing: float = 0.1) -> torch.Tensor:
    log_probs = F.log_softmax(logits, dim=-1)
    off = smoothing / (num_classes - 1)
    one_hot = F.one_hot(labels.long(), num_classes).to(log_probs.dtype) * (1.0 - smoothing - off) + off
    return (-one_hot * log_probs).sum(-1).mean()


def combined_loss(logits: torch.Tensor, labels: torch.Tensor,
                  features: Optional[torch.Tensor] = None,
                  weights: Optional[Dict[str, float]] = None,
                  class_weights: Optional[torch.Tensor] = None, focal_gamma: float = 2.0,
                  contrastive_margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """Weighted CE + focal + contrastive: {'total', 'ce', 'focal', 'contrastive'}."""
    weights = weights or {"ce": 1.0, "focal": 0.5, "contrastive": 0.2}
    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    if weights.get("ce", 0.0) > 0:
        losses["ce"] = cross_entropy_loss(logits, labels, class_weights)
        total = total + weights["ce"] * losses["ce"]
    if weights.get("focal", 0.0) > 0:
        losses["focal"] = focal_loss(logits, labels, gamma=focal_gamma, alpha=class_weights)
        total = total + weights["focal"] * losses["focal"]
    if features is not None and weights.get("contrastive", 0.0) > 0 and features.shape[0] >= 2:
        # Adjacent even/odd pairs in batch order.
        feat1, feat2 = features[:-1:2], features[1::2]
        lab1, lab2 = labels[:-1:2], labels[1::2]
        n = min(feat1.shape[0], feat2.shape[0])
        pair = (lab1[:n] == lab2[:n]).float()
        losses["contrastive"] = contrastive_loss(feat1[:n], feat2[:n], pair,
                                                 margin=contrastive_margin)
        total = total + weights["contrastive"] * losses["contrastive"]
    losses["total"] = total
    return losses


def make_criterion(loss_cfg: Optional[Dict], class_weights: Optional[torch.Tensor] = None
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The config's loss block to ``criterion(logits, labels, features=None)``
    → dict with 'total'. ``loss_cfg['class_weights']`` overrides
    ``class_weights``; a weight tensor moves to the logits' device."""
    kind = (loss_cfg or {}).get("type", "CombinedLoss")
    cw = class_weights
    if loss_cfg and loss_cfg.get("class_weights") is not None:
        cw = torch.as_tensor(loss_cfg["class_weights"], dtype=torch.float32)
    if cw is not None:
        cw = torch.as_tensor(cw, dtype=torch.float32)

    def weights_on(logits: torch.Tensor) -> Optional[torch.Tensor]:
        return None if cw is None else cw.to(logits.device)

    if kind == "CrossEntropy":
        return lambda logits, labels, features=None: {
            "total": cross_entropy_loss(logits, labels, weights_on(logits))}
    if kind == "FocalLoss":
        gamma = loss_cfg.get("focal_gamma", 2.0)
        return lambda logits, labels, features=None: {
            "total": focal_loss(logits, labels, gamma=gamma, alpha=weights_on(logits))}
    if kind == "LabelSmoothing":
        smoothing = loss_cfg.get("smoothing", 0.1)
        return lambda logits, labels, features=None: {
            "total": label_smoothing_loss(logits, labels, num_classes=logits.shape[-1],
                                          smoothing=smoothing)}
    if kind == "CombinedLoss":
        weights = (loss_cfg or {}).get("weights", None)
        gamma = (loss_cfg or {}).get("focal_gamma", 2.0)
        return lambda logits, labels, features=None: combined_loss(
            logits, labels, features, weights=weights, class_weights=weights_on(logits),
            focal_gamma=gamma)
    raise ValueError(f"unknown loss type: {kind}")
