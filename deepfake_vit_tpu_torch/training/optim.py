"""Optimizers, gradient clipping and the per-epoch learning-rate schedulers.

Counterpart of the JAX package's ``training/optim.py``. The optimizers are
``torch.optim`` ones set up to compute what the optax transforms compute:

- ``Adam`` / ``AdamW`` (eps outside the square root; AdamW decays every
  parameter, biases and BatchNorm scales included, as ``optax.adamw`` with
  no mask does), ``SGD`` with momentum, Nesterov by default, no dampening
  and no weight decay (``optax.sgd``).
- Global-norm clipping is optax's ``clip_by_global_norm``: the gradients
  are left alone when their global norm is below ``max_norm`` and scaled
  by ``max_norm / norm`` otherwise (no ``+1e-6`` as in
  ``torch.nn.utils.clip_grad_norm_``). The optimizer carries its clip as
  ``optimizer.gradient_clip``; the train step applies it over every
  parameter of the model.
- ``create_optimizer_with_param_groups``: AdamW over the 'stem', 'blocks'
  and 'head' groups of ``models.efficientnet.param_group_labels`` at
  0.1×, 0.5× and 1× the base rate; parameters that ``frozen_mask`` marks
  False are left out, so they get no update and no decay.

``set_learning_rate`` / ``get_learning_rate`` act on ``param_groups``. The
JAX functions look for the injected learning rate only at the top of an
optax chain, so they neither change nor read a param-group optimizer's
rates; the port does the same (``optimizer.scheduled`` is False there).

The scheduler classes are copied as they are: host-side, stepped once an
epoch, ``lr = sched.step(epoch, val_loss)``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.efficientnet import param_group_labels


def create_optimizer(params: Iterable[torch.nn.Parameter], opt_cfg: Dict[str, Any],
                     gradient_clip: Optional[float] = None) -> torch.optim.Optimizer:
    """The config's ``training.optimizer`` block as a torch optimizer over
    ``params``; ``gradient_clip`` > 0 clips by global norm."""
    kind = opt_cfg.get("type", "AdamW")
    lr = float(opt_cfg.get("lr", 1e-4))
    wd = float(opt_cfg.get("weight_decay", 1e-4))
    betas = tuple(float(b) for b in opt_cfg.get("betas", [0.9, 0.999]))
    params = list(params)
    if kind == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    elif kind == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    elif kind == "SGD":
        momentum = float(opt_cfg.get("momentum", 0.9))
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                              nesterov=bool(opt_cfg.get("nesterov", True)) and momentum > 0)
    else:
        raise ValueError(f"unknown optimizer: {kind}")
    opt.gradient_clip = float(gradient_clip) if gradient_clip and gradient_clip > 0 else None
    opt.scheduled = True
    return opt


def create_optimizer_with_param_groups(
    model: nn.Module,
    base_lr: float = 1e-4,
    group_lr_scale: Optional[Dict[str, float]] = None,
    weight_decay: float = 1e-4,
    gradient_clip: Optional[float] = None,
    frozen_mask: Optional[Dict[str, bool]] = None,
) -> torch.optim.Optimizer:
    """Discriminative-rate AdamW: one param group a label ('stem' 0.1×,
    'blocks' 0.5×, 'head' 1× ``base_lr`` unless ``group_lr_scale`` says
    otherwise), each group named by its label; ``frozen_mask`` (parameter
    name → trainable, from ``models.efficientnet.frozen_stage_mask``)
    leaves the False ones out."""
    scales = {"stem": 0.1, "blocks": 0.5, "head": 1.0, **(group_lr_scale or {})}
    labels = param_group_labels(model)
    named = dict(model.named_parameters())
    groups = []
    for name, scale in scales.items():
        params = [p for n, p in named.items()
                  if labels[n] == name and (frozen_mask is None or frozen_mask[n])]
        if params:
            groups.append({"params": params, "lr": base_lr * scale, "name": name})
    opt = torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    opt.gradient_clip = float(gradient_clip) if gradient_clip and gradient_clip > 0 else None
    opt.scheduled = False
    return opt


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient (optax.global_norm), as the norm of
    the per-tensor norms."""
    return torch.nn.utils.get_total_norm(grads)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` in place as optax's ``clip_by_global_norm`` does
    (unchanged below ``max_norm``, else by ``max_norm / norm``); returns
    the norm before clipping. No host synchronization."""
    norm = global_norm(grads) if norm is None else norm
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))
    return norm


def clip_and_step(optimizer: torch.optim.Optimizer, params: List[torch.nn.Parameter]) -> torch.Tensor:
    """One optimizer update from the gradients of ``params`` (every
    parameter of the model, those the optimizer leaves out included): a
    missing gradient counts as zeros (optax sees zeros there), the global
    norm is taken and, with ``optimizer.gradient_clip``, clipped; returns
    the norm before clipping."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    clip = getattr(optimizer, "gradient_clip", None)
    if clip:
        clip_by_global_norm_(grads, clip, norm)
    optimizer.step()
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group (nothing for a param-group
    optimizer, as in the JAX package)."""
    if getattr(optimizer, "scheduled", True):
        for group in optimizer.param_groups:
            group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    if not getattr(optimizer, "scheduled", True):
        return None
    return float(optimizer.param_groups[0]["lr"])


def optimizer_state_tree(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` as a msgpack-ready tree: string keys,
    numpy leaves, tuples as lists."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, dict):
            return {str(k): conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v

    return conv(optimizer.state_dict())


def load_optimizer_state(optimizer: torch.optim.Optimizer, tree: Dict[str, Any]) -> None:
    """Inverse of :func:`optimizer_state_tree`."""
    if not isinstance(tree, dict) or set(tree) != {"state", "param_groups"}:
        raise ValueError("opt_state is not a torch optimizer's state (an optax state from the "
                         "JAX package cannot be resumed by the port)")

    def tensors(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.array(v))
        if isinstance(v, dict):
            return {k: tensors(x) for k, x in v.items()}
        return v

    groups = []
    for g in tree["param_groups"]:
        g = dict(g)
        if "betas" in g:
            g["betas"] = tuple(g["betas"])
        g["params"] = [int(i) for i in g["params"]]
        groups.append(g)
    optimizer.load_state_dict({"state": {int(k): tensors(v) for k, v in tree["state"].items()},
                               "param_groups": groups})


class LRScheduler:
    """Per-epoch scheduler protocol: ``lr = sched.step(epoch, val_loss)``."""

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)


class StepLR(LRScheduler):
    def __init__(self, base_lr: float, step_size: int = 30, gamma: float = 0.1):
        self.base_lr, self.step_size, self.gamma = base_lr, step_size, gamma

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.base_lr * self.gamma ** (epoch // self.step_size)


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr: float, T_max: int = 50, eta_min: float = 1e-6):
        self.base_lr, self.T_max, self.eta_min = base_lr, T_max, eta_min

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.T_max)
        ) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    """SGDR: cosine anneal within restart cycles of length T_0·T_mult^i."""

    def __init__(self, base_lr: float, T_0: int = 10, T_mult: int = 2, eta_min: float = 1e-6):
        self.base_lr, self.T_0, self.T_mult, self.eta_min = base_lr, T_0, T_mult, eta_min

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        t_cur, t_i = float(epoch), float(self.T_0)
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)
        ) / 2


class ReduceLROnPlateau(LRScheduler):
    def __init__(
        self,
        base_lr: float,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 5,
        min_lr: float = 1e-6,
        threshold: float = 1e-4,
    ):
        self.lr = base_lr
        self.mode, self.factor, self.patience = mode, factor, patience
        self.min_lr, self.threshold = min_lr, threshold
        self.best: Optional[float] = None
        self.num_bad = 0

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        if val_loss is None:
            return self.lr
        improved = (
            self.best is None
            or (self.mode == "min" and val_loss < self.best - self.threshold)
            or (self.mode == "max" and val_loss > self.best + self.threshold)
        )
        if improved:
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


class ConstantLR(LRScheduler):
    def __init__(self, base_lr: float):
        self.base_lr = base_lr

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        return self.base_lr


def create_scheduler(sched_cfg: Optional[Dict[str, Any]], base_lr: float) -> LRScheduler:
    """Build a scheduler from the model_config 'scheduler' block."""
    if not sched_cfg:
        return ConstantLR(base_lr)
    kind = sched_cfg.get("type", "CosineAnnealingWarmRestarts")
    if kind in (None, "none", "None"):
        return ConstantLR(base_lr)
    if kind == "StepLR":
        return StepLR(base_lr, int(sched_cfg.get("step_size", 30)), float(sched_cfg.get("gamma", 0.1)))
    if kind == "CosineAnnealingLR":
        return CosineAnnealingLR(base_lr, int(sched_cfg.get("T_max", 50)), float(sched_cfg.get("eta_min", 1e-6)))
    if kind == "CosineAnnealingWarmRestarts":
        return CosineAnnealingWarmRestarts(
            base_lr,
            int(sched_cfg.get("T_0", 10)),
            int(sched_cfg.get("T_mult", 2)),
            float(sched_cfg.get("eta_min_restart", sched_cfg.get("eta_min", 1e-6))),
        )
    if kind == "ReduceLROnPlateau":
        return ReduceLROnPlateau(
            base_lr,
            mode=sched_cfg.get("mode", "min"),
            factor=float(sched_cfg.get("factor", 0.5)),
            patience=int(sched_cfg.get("patience", 5)),
            min_lr=float(sched_cfg.get("min_lr", 1e-6)),
        )
    raise ValueError(f"unknown scheduler: {kind}")
