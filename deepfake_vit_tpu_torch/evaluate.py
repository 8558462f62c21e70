"""Evaluate a checkpoint on a split.

    python -m deepfake_vit_tpu_torch.evaluate --checkpoint CKPT [--config MODEL.yaml|.json]
        [--batch-size B] [--split test] [--processed-dir DIR] [--output-dir outputs]
        [--detailed] [--device cuda|cpu]

The flags of the JAX package's ``scripts/evaluate.py``, plus ``--device``:
loads the checkpoint's ``params`` and ``batch_stats`` (a file written by
either package's trainer), evaluates the split with the full metric
suite, with ``--detailed`` adds per-class accuracy and accuracy/coverage
at confidence 0.5/0.7/0.9, and writes ``eval_{split}.json`` and
``predictions_{split}.npz`` under ``--output-dir``. ``--visualize`` (the
prediction grid) is not ported (ROADMAP Queue A item 9). Runs on the card
unless ``--device cpu`` is given; without a card it fails.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

log = logging.getLogger("evaluate")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate a trained model (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    parser.add_argument("--processed-dir", type=str, default=None)
    parser.add_argument("--output-dir", type=str, default="outputs")
    parser.add_argument("--detailed", action="store_true")
    parser.add_argument("--visualize", action="store_true",
                        help="not ported (ROADMAP Queue A item 9)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    if args.visualize:
        raise NotImplementedError("--visualize: the visualization utilities are not ported "
                                  "(ROADMAP Queue A item 9)")

    from .data import create_dataloaders
    from .device import resolve_device
    from .models.bridge import load_flax_variables
    from .models.feature_extractor import create_model_from_config
    from .train import load_run_config
    from .training import Evaluator, make_criterion
    from .utils.io_utils import load_checkpoint, save_metrics

    device = resolve_device(args.device)
    config = load_run_config(args.config)
    data_cfg = config.get("data", {})
    processed_dir = args.processed_dir or data_cfg.get("processed_dir", "data/processed")
    loaders = create_dataloaders(
        processed_dir, batch_size=args.batch_size or data_cfg.get("batch_size", 64),
        num_workers=data_cfg.get("num_workers", 4),
        use_landmarks=data_cfg.get("use_landmarks", True), splits=(args.split,),
        image_size=data_cfg.get("image_size", 224), cache=data_cfg.get("cache"))
    if args.split not in loaders:
        log.error(f"no {args.split} split found under {processed_dir}/splits")
        return 1
    loader = loaders[args.split]

    train_cfg = config.get("training", {})
    dtype = torch.bfloat16 if train_cfg.get("use_amp", True) else torch.float32
    model = create_model_from_config(config.get("model", {}), dtype=dtype).to(device)
    ckpt = load_checkpoint(args.checkpoint)
    load_flax_variables(model, {"params": ckpt["params"],
                                "batch_stats": ckpt.get("batch_stats", {})})
    log.info(f"loaded checkpoint {args.checkpoint} (epoch {ckpt.get('epoch')}) on {device}")

    evaluator = Evaluator(model, make_criterion(train_cfg.get("loss", {})),
                          data_cfg.get("use_landmarks", True))
    metrics = evaluator.evaluate(loader, return_predictions=True)
    evaluator.print_metrics(metrics, log, title=f"{args.split} evaluation")
    preds = metrics.pop("predictions")
    probs = metrics.pop("probabilities")
    labels = metrics.pop("labels")

    if args.detailed:
        log.info("--- detailed ---")
        for cls, name in ((0, "real"), (1, "fake")):
            mask = labels == cls
            if mask.sum():
                acc = float((preds[mask] == cls).mean())
                log.info(f"  class {name}: accuracy {acc:.4f} (n={int(mask.sum())})")
        conf = probs.max(axis=1)
        for th in (0.5, 0.7, 0.9):
            mask = conf >= th
            acc = float((preds[mask] == labels[mask]).mean()) if mask.sum() else float("nan")
            log.info(f"  conf ≥ {th}: accuracy {acc:.4f} coverage {float(mask.mean()):.4f}")

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_metrics({k: v for k, v in metrics.items() if isinstance(v, (int, float, list))},
                 out_dir / f"eval_{args.split}.json")
    np.savez(out_dir / f"predictions_{args.split}.npz", preds=preds, probs=probs, labels=labels)
    log.info(f"wrote {out_dir}/eval_{args.split}.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
