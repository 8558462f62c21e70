"""Trainer: the epoch loop, checkpoints and resume.

Counterpart of the JAX package's ``training/trainer.py``, with its
defaults (epochs 100, clip 1.0, accumulation 1, early-stopping patience 15
and min_delta 1e-3, save_freq 5) and its loop: per epoch, ``set_epoch`` on
the train loader, the train steps, validation, the scheduler stepped with
``(epoch + 1, val_loss)`` and its rate written into the optimizer, a
checkpoint on ``save_freq`` or a new best validation accuracy, early
stopping on a validation loss that stops improving by ``min_delta``.

A checkpoint is the JAX package's: ``epoch``, ``step``, ``params`` and
``batch_stats`` in flax layout (``models/bridge.py``), ``opt_state``,
``metrics``, ``best_metrics``, ``scheduler`` and ``config``. Its
``opt_state`` is the torch optimizer's ``state_dict`` in numpy, not an
optax state: the JAX package reads such a file with
``restore_train_state(restore_opt=False)``, and the port resumes only
its own. Resume continues the epoch numbering, the scheduler, the
optimizer and the step count (which seeds the masks and augmentation).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.bridge import export_flax_variables, load_flax_variables
from ..utils.io_utils import load_checkpoint, save_checkpoint
from .evaluator import Evaluator, MetricsTracker
from .optim import LRScheduler, get_learning_rate, load_optimizer_state, optimizer_state_tree
from .optim import set_learning_rate
from .train_state import TrainState, make_train_step

_DEFAULTS = dict(
    num_epochs=100,
    gradient_clip=1.0,
    accumulation_steps=1,
    use_amp=True,
    early_stopping_patience=15,
    early_stopping_min_delta=1e-3,
    save_freq=5,
    print_freq=10,
    max_keep=5,
    save_dir="checkpoints",
    save_best_only=False,
    remat=False,
    tb_dir=None,
)


def _rss_mb() -> float:
    """Resident set size in MB (Linux /proc; 0.0 where unavailable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class Trainer:
    """``seed`` seeds the masks and the augmentation of every step (with
    the step's number). ``config['tb_dir']`` asks for TensorBoard event
    files, whose writer is not ported (ROADMAP Queue A item 9)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, criterion: Callable,
                 train_loader: Iterable, val_loader: Iterable,
                 scheduler: Optional[LRScheduler] = None, config: Optional[Dict[str, Any]] = None,
                 use_landmarks: bool = True, seed: int = 0, logger=None,
                 augment_fn: Optional[Callable] = None):
        self.model = model
        self.optimizer = optimizer
        self.criterion = criterion
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.scheduler = scheduler
        self.logger = logger
        self.config = {**_DEFAULTS, **(config or {})}
        if self.config.get("tb_dir"):
            raise NotImplementedError("TensorBoard event files (tb_dir): the writer is not "
                                      "ported (ROADMAP Queue A item 9)")
        self.seed = int(seed)
        self.state = TrainState()
        self.train_step = make_train_step(
            model, criterion, optimizer, accumulation_steps=self.config["accumulation_steps"],
            use_landmarks=use_landmarks, augment_fn=augment_fn, remat=self.config["remat"])
        self.evaluator = Evaluator(model, criterion, use_landmarks)
        self.tracker = MetricsTracker()
        self._early_stop_best: Optional[float] = None
        self._early_stop_count = 0

    def _log(self, msg: str) -> None:
        (self.logger.info if self.logger else print)(msg)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        # The shuffle order is a function of (seed, epoch): exact-order resume.
        set_epoch = getattr(self.train_loader, "set_epoch", None)
        if callable(set_epoch):
            set_epoch(epoch)
        sums: Dict[str, float] = {}
        n = 0
        t0 = time.perf_counter()
        for i, batch in enumerate(self.train_loader):
            metrics = {k: float(v) for k, v in self.train_step(self.state, batch, self.seed).items()}
            n += 1
            if (i + 1) % max(self.config["print_freq"], 1) == 0:
                self._log(f"epoch {epoch} step {i + 1}: "
                          f"loss={metrics['loss']:.4f} acc={metrics['accuracy']:.4f}")
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        elapsed = time.perf_counter() - t0
        if n == 0:
            return {"loss": float("nan"), "accuracy": float("nan"), "epoch_time_s": elapsed}
        out = {k: v / n for k, v in sums.items()}
        out["epoch_time_s"] = elapsed
        out["steps_per_sec"] = n / elapsed if elapsed > 0 else float("nan")
        return out

    def validate(self, epoch: int) -> Dict[str, Any]:
        return self.evaluator.evaluate(self.val_loader)

    def train(self, start_epoch: int = 0) -> MetricsTracker:
        total_t0 = time.perf_counter()
        num_epochs = self.config["num_epochs"]
        for epoch in range(start_epoch, num_epochs):
            train_metrics = self.train_epoch(epoch)
            val_metrics = self.validate(epoch)

            if self.scheduler is not None:
                lr = self.scheduler.step(epoch + 1, val_metrics.get("loss"))
                set_learning_rate(self.optimizer, lr)
            else:
                lr = get_learning_rate(self.optimizer)

            is_best = self.tracker.update(epoch, train_metrics, val_metrics, lr)
            periodic = (epoch + 1) % self.config["save_freq"] == 0
            if is_best or (periodic and not self.config["save_best_only"]):
                self.save_checkpoint(epoch, is_best=is_best)

            self._log(
                f"[epoch {epoch + 1}/{num_epochs}] "
                f"train_loss={train_metrics['loss']:.4f} train_acc={train_metrics['accuracy']:.4f} "
                f"val_loss={val_metrics['loss']:.4f} val_acc={val_metrics['accuracy']:.4f} "
                f"val_auc={val_metrics.get('roc_auc', float('nan')):.4f} "
                f"lr={lr if lr is not None else float('nan'):.2e} "
                f"rss={_rss_mb():.0f}MB ({train_metrics['epoch_time_s']:.1f}s)"
                + (" *best*" if is_best else "")
            )
            if self._early_stopping(val_metrics["loss"]):
                self._log(f"early stopping at epoch {epoch + 1}")
                break

        self._log(f"training done in {time.perf_counter() - total_t0:.1f}s")
        self.tracker.summary(self.logger)
        return self.tracker

    def _early_stopping(self, val_loss: float) -> bool:
        min_delta = self.config["early_stopping_min_delta"]
        if self._early_stop_best is None or val_loss < self._early_stop_best - min_delta:
            self._early_stop_best = val_loss
            self._early_stop_count = 0
            return False
        self._early_stop_count += 1
        return self._early_stop_count >= self.config["early_stopping_patience"]

    def checkpoint_state(self, epoch: int) -> Dict[str, Any]:
        """The checkpoint's tree (see the module docstring)."""
        variables = export_flax_variables(self.model)
        return {
            "epoch": epoch,
            "step": int(self.state.step),
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": optimizer_state_tree(self.optimizer),
            "metrics": self.tracker.state_dict(),
            "best_metrics": self.tracker.best_metrics,
            "scheduler": self.scheduler.state_dict() if self.scheduler else None,
            "config": {k: v for k, v in self.config.items()
                       if isinstance(v, (int, float, str, bool))},
        }

    def save_checkpoint(self, epoch: int, is_best: bool = False) -> Path:
        return save_checkpoint(self.checkpoint_state(epoch), self.config["save_dir"],
                               is_best=is_best, max_keep=self.config["max_keep"])

    def resume_from_checkpoint(self, path) -> int:
        """Restore the model, optimizer, scheduler, tracker and step count;
        returns the next epoch index."""
        ckpt = load_checkpoint(path)
        load_flax_variables(self.model, {"params": ckpt["params"],
                                         "batch_stats": ckpt.get("batch_stats", {})})
        load_optimizer_state(self.optimizer, ckpt["opt_state"])
        self.state.step = int(ckpt.get("step", 0))
        if self.scheduler is not None and ckpt.get("scheduler"):
            self.scheduler.load_state_dict(ckpt["scheduler"])
        if ckpt.get("metrics"):
            self.tracker.load_state_dict(_delistify(ckpt["metrics"]))
        epoch = int(ckpt.get("epoch", -1))
        self._log(f"resumed from {path} at epoch {epoch}")
        return epoch + 1


def _delistify(obj):
    """msgpack round-trips numbers as numpy scalars; normalize to Python."""
    if isinstance(obj, dict):
        return {k: _delistify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_delistify(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
