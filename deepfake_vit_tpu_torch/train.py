"""Train the classifier.

    python -m deepfake_vit_tpu_torch.train [--config MODEL.yaml|.json] [--resume CKPT]
        [--processed-dir DIR] [--epochs N] [--batch-size B] [--device cuda|cpu]

The flags of the JAX package's ``scripts/train.py``, plus ``--device``.
Seeded end to end from the config (``configs.TRAINING_CONFIG``, the
JAX package's ``model_config.yaml``, by default): the loaders of
``{processed_dir}/splits/*.csv`` (``DeviceLoader``s onto the run's device,
or with ``data.cache: device`` the splits kept on it), class weights from the train split, the
model (bf16 activations when ``training.use_amp``), the optimizer with
global-norm clipping, the scheduler, the criterion, on-device
augmentation when ``data.augmentation.enabled``, then ``Trainer.train``
with rotating checkpoints and ``best_model.ckpt`` under
``checkpoint.save_dir``, and a final evaluation on the test split when
there is one. ``--resume`` continues a checkpoint this CLI wrote. It logs
to the console and to ``{logging.log_dir}/train.log`` and writes
TensorBoard event files under ``{logging.log_dir}/tb``, as the JAX CLI
does. ``model.type: vit`` trains the ViT fallback family, which the JAX
CLI cannot (it reads a ``batch_stats`` collection a ViT does not have).
Runs on the card unless ``--device cpu`` is given; without a card it
fails.
"""

from __future__ import annotations

import argparse
import copy
import random
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def load_run_config(path: Optional[str]):
    """The config at ``path`` (YAML or JSON), else the packaged default."""
    from .configs import TRAINING_CONFIG
    from .utils.io_utils import load_config

    return load_config(path) if path else copy.deepcopy(TRAINING_CONFIG)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Train the deepfake detection model (PyTorch port)")
    parser.add_argument("--config", type=str, default=None, help="model config (YAML or JSON)")
    parser.add_argument("--resume", type=str, default=None, help="checkpoint to resume from")
    parser.add_argument("--processed-dir", type=str, default=None, help="override data dir")
    parser.add_argument("--epochs", type=int, default=None, help="override num_epochs")
    parser.add_argument("--batch-size", type=int, default=None, help="override batch size")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)

    from .data import create_dataloaders
    from .device import resolve_device
    from .models.feature_extractor import create_model_from_config
    from .models.layers import init_weights
    from .ops.augment import make_augment_fn
    from .training import (Trainer, create_optimizer, create_scheduler, make_criterion)
    from .utils.io_utils import count_parameters
    from .utils.logger import setup_logger

    device = resolve_device(args.device)
    config = load_run_config(args.config)
    log_dir = Path(config.get("logging", {}).get("log_dir", "runs"))
    log = setup_logger("train", str(log_dir / "train.log"))
    seed = int(config.get("seed", 42))
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)

    data_cfg = config.get("data", {})
    processed_dir = args.processed_dir or data_cfg.get("processed_dir", "data/processed")
    loaders = create_dataloaders(
        processed_dir, batch_size=args.batch_size or data_cfg.get("batch_size", 64),
        num_workers=data_cfg.get("num_workers", 4),
        use_landmarks=data_cfg.get("use_landmarks", True), seed=seed,
        image_size=data_cfg.get("image_size", 224), cache=data_cfg.get("cache"), device=device)
    if "train" not in loaders:
        log.error(f"no train split found under {processed_dir}/splits")
        return 1
    class_weights = loaders["train"].dataset.get_class_weights()
    log.info(f"device {device}; class weights: {class_weights.tolist()}")

    train_cfg = config.get("training", {})
    dtype = torch.bfloat16 if train_cfg.get("use_amp", True) else torch.float32
    model = init_weights(create_model_from_config(config.get("model", {}), dtype=dtype), seed)
    model.to(device)
    log.info(f"model params: {count_parameters(model):,}")
    opt_cfg = train_cfg.get("optimizer", {})
    optimizer = create_optimizer(model.parameters(), opt_cfg,
                                 gradient_clip=train_cfg.get("gradient_clip"))
    scheduler = create_scheduler(train_cfg.get("scheduler"), float(opt_cfg.get("lr", 1e-4)))
    criterion = make_criterion(train_cfg.get("loss", {}), torch.as_tensor(class_weights))
    augment_fn = make_augment_fn(data_cfg.get("augmentation"))
    if augment_fn is not None:
        log.info("on-device augmentation enabled")

    ckpt_cfg = config.get("checkpoint", {})
    trainer = Trainer(
        model, optimizer, criterion, train_loader=loaders["train"],
        val_loader=loaders.get("val", loaders["train"]), scheduler=scheduler,
        augment_fn=augment_fn, use_landmarks=data_cfg.get("use_landmarks", True), seed=seed,
        logger=log,
        config={
            "num_epochs": args.epochs or train_cfg.get("num_epochs", 100),
            "gradient_clip": train_cfg.get("gradient_clip", 1.0),
            "accumulation_steps": train_cfg.get("accumulation_steps", 1),
            "use_amp": train_cfg.get("use_amp", True),
            "remat": train_cfg.get("remat", False),
            "early_stopping_patience": config.get("early_stopping", {}).get("patience", 15),
            "early_stopping_min_delta": config.get("early_stopping", {}).get("min_delta", 1e-3),
            "save_freq": config.get("validation", {}).get("save_freq", 5),
            "print_freq": config.get("validation", {}).get("print_freq", 10),
            "save_dir": ckpt_cfg.get("save_dir", "checkpoints"),
            "max_keep": ckpt_cfg.get("max_keep", 5),
            "save_best_only": ckpt_cfg.get("save_best_only", False),
            "tb_dir": str(log_dir / "tb"),
        })
    start_epoch = trainer.resume_from_checkpoint(args.resume) if args.resume else 0
    trainer.train(start_epoch)

    if "test" in loaders:
        log.info("final test evaluation")
        trainer.evaluator.print_metrics(trainer.evaluator.evaluate(loaders["test"]), log,
                                        title="Test")
    return 0


if __name__ == "__main__":
    sys.exit(main())
