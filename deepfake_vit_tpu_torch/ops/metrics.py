"""Classification metrics on the host, in numpy.

A copy of the JAX package's ``ops/metrics.py``: accuracy, binary
precision/recall/F1, ROC-AUC (the tie-aware Mann-Whitney rank statistic),
average precision (the step-wise precision sum over distinct thresholds),
the confusion matrix with TN/FP/FN/TP, specificity and sensitivity.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix_binary(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    labels = np.asarray(labels).astype(np.int64)
    preds = np.asarray(preds).astype(np.int64)
    cm = np.zeros((2, 2), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Tie-aware AUC via average ranks (Mann-Whitney U)."""
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[labels == 1].sum()
    return float((rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """Step-wise AP over *distinct* thresholds (tie-grouped, sklearn semantics)."""
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    sorted_labels = labels[order]
    sorted_scores = scores[order]
    tp_cum = np.cumsum(sorted_labels).astype(np.float64)
    k = np.arange(1, len(labels) + 1, dtype=np.float64)
    # Threshold boundaries = last index of each tied-score group.
    boundary = np.nonzero(np.diff(sorted_scores))[0]
    idx = np.concatenate([boundary, [len(labels) - 1]])
    precision = tp_cum[idx] / k[idx]
    recall = tp_cum[idx] / n_pos
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def binary_classification_metrics(
    labels: np.ndarray,
    preds: np.ndarray,
    probs_fake: np.ndarray | None = None,
) -> Dict[str, float]:
    """Full metric suite. ``probs_fake`` = P(class 1) enables AUC/AP."""
    labels = np.asarray(labels).astype(np.int64)
    preds = np.asarray(preds).astype(np.int64)
    cm = confusion_matrix_binary(labels, preds)
    tn, fp = int(cm[0, 0]), int(cm[0, 1])
    fn, tp = int(cm[1, 0]), int(cm[1, 1])

    accuracy = (tp + tn) / max(len(labels), 1)
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
    specificity = tn / (tn + fp) if (tn + fp) > 0 else 0.0

    metrics = {
        "accuracy": float(accuracy),
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
        "specificity": float(specificity),
        "sensitivity": float(recall),
        "confusion_matrix": cm.tolist(),
        "tn": tn,
        "fp": fp,
        "fn": fn,
        "tp": tp,
    }
    if probs_fake is not None:
        metrics["roc_auc"] = roc_auc(labels, probs_fake)
        metrics["average_precision"] = average_precision(labels, probs_fake)
    return metrics
