"""The train and eval steps.

Counterpart of the JAX package's ``training/train_state.py``. The model
holds the parameters and the BatchNorm statistics, the optimizer its
moments; ``TrainState`` counts the steps taken. One train step:

- moves the batch to the model's device and, with ``augment_fn``, augments
  it without autograd;
- runs the model in train mode (bf16 activations when the model's dtype
  is bf16, float32 parameters) and the criterion, and backpropagates with
  ``torch.autograd``;
- with ``accumulation_steps`` A > 1, runs the A microbatches in order (each
  moves the running statistics), sums their gradients and scales them by
  1/A, and averages their metrics;
- clips by global norm when the optimizer carries ``gradient_clip``
  (``metrics["grad_norm"]`` is the norm before clipping) and steps the
  optimizer.

Randomness: the augmentation and the masks of dropout and drop-connect
draw from generators on the device seeded by (seed, step), so a resumed
run redraws what the original run drew. ``remat=True`` reruns the forward
in the backward (``torch.utils.checkpoint``); the rerun restores the mask
generator's saved state and leaves the running statistics alone, so it
gives the step ``remat=False`` gives.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..data.dataset import batch_to_device
from ..models.layers import running_stats_frozen
from .optim import clip_and_step


@dataclass
class TrainState:
    """The number of train steps taken (JAX's ``TrainState.step``)."""

    step: int = 0


def step_generator(seed: int, step: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded by (seed, step, stream): stream 0
    feeds the augmentation, stream 1 the dropout masks."""
    state = np.random.SeedSequence([int(seed), int(step), int(stream)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _forward(model: nn.Module, images, landmarks, generator: torch.Generator, remat: bool):
    if not remat:
        return model(images, landmarks, generator=generator)
    saved = generator.get_state()
    calls = [0]

    def run(images, landmarks):
        generator.set_state(saved)  # the rerun draws the same masks
        rerun = calls[0] > 0
        calls[0] += 1
        with running_stats_frozen(model) if rerun else contextlib.nullcontext():
            return model(images, landmarks, generator=generator)

    return torch.utils.checkpoint.checkpoint(run, images, landmarks, use_reentrant=False,
                                             preserve_rng_state=False)


def _forward_loss(model, criterion, batch, generator, use_landmarks: bool, remat: bool = False):
    landmarks = batch.get("landmarks") if use_landmarks else None
    logits, features = _forward(model, batch["image"], landmarks, generator, remat)
    losses = criterion(logits, batch["label"], features)
    metrics = {f"loss_{k}": v.detach() for k, v in losses.items()}
    metrics["loss"] = losses["total"].detach()
    metrics["accuracy"] = (logits.detach().argmax(-1) == batch["label"]).float().mean()
    return losses["total"], metrics


def make_train_step(model: nn.Module, criterion: Callable, optimizer: torch.optim.Optimizer,
                    accumulation_steps: int = 1, use_landmarks: bool = True,
                    augment_fn: Optional[Callable] = None, remat: bool = False):
    """``step(state, batch, seed) -> metrics`` (0-d tensors on the device);
    updates the model and the optimizer in place and advances
    ``state.step``."""
    A = int(accumulation_steps)

    def step(state: TrainState, batch: Dict[str, Any], seed: int) -> Dict[str, torch.Tensor]:
        dev = _device(model)
        batch = batch_to_device(batch, dev)
        if augment_fn is not None:
            batch = augment_fn(batch, step_generator(seed, state.step, 0, dev))
        generator = step_generator(seed, state.step, 1, dev)
        model.train()
        model.zero_grad(set_to_none=True)
        n = batch["image"].shape[0]
        if A > 1 and n % A:
            raise ValueError(f"batch of {n} does not split into {A} microbatches")
        m = n // A
        sums: Dict[str, torch.Tensor] = {}
        for i in range(A):
            micro = {k: v[i * m:(i + 1) * m] if isinstance(v, torch.Tensor) else v
                     for k, v in batch.items()} if A > 1 else batch
            loss, metrics = _forward_loss(model, criterion, micro, generator, use_landmarks, remat)
            loss.backward()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        params = list(model.parameters())
        if A > 1:
            inv = 1.0 / A
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            sums = {k: v * inv for k, v in sums.items()}
        sums["grad_norm"] = clip_and_step(optimizer, params)
        state.step += 1
        return sums

    return step


def make_eval_step(model: nn.Module, criterion: Callable, use_landmarks: bool = True):
    """``eval_step(batch) -> {loss, probs, preds, labels}`` on the device,
    the model in eval mode and without autograd."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        model.eval()
        batch = batch_to_device(batch, _device(model))
        landmarks = batch.get("landmarks") if use_landmarks else None
        logits, features = model(batch["image"], landmarks)
        losses = criterion(logits, batch["label"], features)
        return {"loss": losses["total"], "probs": torch.softmax(logits, dim=-1),
                "preds": logits.argmax(-1), "labels": batch["label"]}

    return eval_step
