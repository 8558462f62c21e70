"""Training of the classifier (counterpart of ``deepfake_vit_tpu.training``:
losses, optimizers and schedulers, the train and eval steps, the
evaluator and the trainer)."""

from .evaluator import Evaluator, MetricsTracker
from .losses import (
    combined_loss,
    contrastive_loss,
    cross_entropy_loss,
    focal_loss,
    label_smoothing_loss,
    make_criterion,
    triplet_loss,
)
from .optim import (
    ConstantLR,
    CosineAnnealingLR,
    CosineAnnealingWarmRestarts,
    LRScheduler,
    ReduceLROnPlateau,
    StepLR,
    create_optimizer,
    create_optimizer_with_param_groups,
    create_scheduler,
    get_learning_rate,
    set_learning_rate,
)
from .train_state import TrainState, make_eval_step, make_train_step
from .trainer import Trainer

__all__ = [
    "ConstantLR", "CosineAnnealingLR", "CosineAnnealingWarmRestarts", "Evaluator",
    "LRScheduler", "MetricsTracker", "ReduceLROnPlateau", "StepLR", "TrainState", "Trainer",
    "combined_loss", "contrastive_loss", "create_optimizer",
    "create_optimizer_with_param_groups", "create_scheduler", "cross_entropy_loss",
    "focal_loss", "get_learning_rate", "label_smoothing_loss", "make_criterion",
    "make_eval_step", "make_train_step", "set_learning_rate", "triplet_loss",
]
