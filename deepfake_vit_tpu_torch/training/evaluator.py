"""Evaluator and MetricsTracker.

Counterpart of the JAX package's ``training/evaluator.py``: the eval loop
runs the model in eval mode without autograd on the model's device,
collects predictions, probabilities and labels, and reduces them on the
host with ``ops/metrics.py`` (accuracy, binary P/R/F1, ROC-AUC, AP,
confusion matrix, specificity, sensitivity); the tracker keeps the epoch
history and the best epoch by validation accuracy.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch.nn as nn

from ..ops.metrics import binary_classification_metrics
from .train_state import make_eval_step


class Evaluator:
    def __init__(self, model: nn.Module, criterion: Callable, use_landmarks: bool = True):
        self.model = model
        self.criterion = criterion
        self.use_landmarks = use_landmarks
        self._eval_step = make_eval_step(model, criterion, use_landmarks)

    def evaluate(self, loader: Iterable[Dict[str, Any]], return_predictions: bool = False,
                 prefix: str = "") -> Dict[str, Any]:
        all_preds: List[np.ndarray] = []
        all_probs: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        losses: List[float] = []
        t0 = time.perf_counter()
        for batch in loader:
            out = {k: v.cpu().numpy() for k, v in self._eval_step(batch).items()}
            losses.append(float(out["loss"]))
            all_preds.append(out["preds"])
            all_probs.append(out["probs"])
            all_labels.append(out["labels"])
        if not losses:
            return {"loss": float("nan"), "num_samples": 0}

        preds = np.concatenate(all_preds)
        probs = np.concatenate(all_probs)
        labels = np.concatenate(all_labels)
        metrics = binary_classification_metrics(labels, preds, probs[:, 1])
        metrics["loss"] = float(np.mean(losses))
        metrics["num_samples"] = int(len(labels))
        metrics["eval_time_s"] = time.perf_counter() - t0
        if prefix:
            metrics = {f"{prefix}{k}": v for k, v in metrics.items()}
        if return_predictions:
            metrics["predictions"] = preds
            metrics["probabilities"] = probs
            metrics["labels"] = labels
        return metrics

    @staticmethod
    def print_metrics(metrics: Dict[str, Any], logger=None, title: str = "Evaluation") -> None:
        out = logger.info if logger else print
        out(f"===== {title} =====")
        for key in (
            "loss",
            "accuracy",
            "precision",
            "recall",
            "f1",
            "roc_auc",
            "average_precision",
            "specificity",
            "sensitivity",
        ):
            if key in metrics and isinstance(metrics[key], (int, float)):
                out(f"  {key:20s}: {metrics[key]:.4f}")
        if "confusion_matrix" in metrics:
            cm = metrics["confusion_matrix"]
            out(f"  confusion matrix    : TN={cm[0][0]} FP={cm[0][1]} FN={cm[1][0]} TP={cm[1][1]}")


class MetricsTracker:
    """Epoch-history tracker; best epoch keyed on val accuracy."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {
            "train_loss": [],
            "train_acc": [],
            "val_loss": [],
            "val_acc": [],
            "val_auc": [],
            "val_f1": [],
            "lr": [],
        }
        self.best_val_acc: float = -float("inf")
        self.best_epoch: int = -1
        self.best_metrics: Dict[str, float] = {}

    def update(
        self,
        epoch: int,
        train_metrics: Dict[str, float],
        val_metrics: Dict[str, float],
        lr: Optional[float] = None,
    ) -> bool:
        """Record one epoch; returns True if this is a new best (val acc)."""
        self.history["train_loss"].append(float(train_metrics.get("loss", float("nan"))))
        self.history["train_acc"].append(float(train_metrics.get("accuracy", float("nan"))))
        self.history["val_loss"].append(float(val_metrics.get("loss", float("nan"))))
        self.history["val_acc"].append(float(val_metrics.get("accuracy", float("nan"))))
        self.history["val_auc"].append(float(val_metrics.get("roc_auc", float("nan"))))
        self.history["val_f1"].append(float(val_metrics.get("f1", float("nan"))))
        self.history["lr"].append(float(lr) if lr is not None else float("nan"))

        val_acc = float(val_metrics.get("accuracy", -float("inf")))
        if val_acc > self.best_val_acc:
            self.best_val_acc = val_acc
            self.best_epoch = epoch
            self.best_metrics = {
                k: float(v) for k, v in val_metrics.items() if isinstance(v, (int, float))
            }
            return True
        return False

    def summary(self, logger=None) -> Dict[str, Any]:
        out = logger.info if logger else print
        info = {
            "best_epoch": self.best_epoch,
            "best_val_acc": self.best_val_acc,
            "best_metrics": self.best_metrics,
            "epochs_run": len(self.history["train_loss"]),
        }
        out(
            f"Best epoch {self.best_epoch}: val_acc={self.best_val_acc:.4f} "
            f"({info['epochs_run']} epochs run)"
        )
        return info

    def state_dict(self) -> Dict[str, Any]:
        return {
            "history": self.history,
            "best_val_acc": self.best_val_acc,
            "best_epoch": self.best_epoch,
            "best_metrics": self.best_metrics,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.history = {k: list(v) for k, v in state["history"].items()}
        self.best_val_acc = state["best_val_acc"]
        self.best_epoch = state["best_epoch"]
        self.best_metrics = dict(state["best_metrics"])
