"""Host-RSS growth diagnostic for long training loops.

    python -m deepfake_vit_tpu_torch.diag_rss --processed-dir DIR [--epochs 8]
        [--action none|gc|clear] [--batch-size 8] [--variant b0] [--device cuda|cpu]

The JAX package's ``scripts/diag_rss.py``, plus ``--device``: N epochs of
the real ``Trainer`` (the variant with a [32] head, bf16, AdamW lr 1e-4
with clip 1.0, CombinedLoss, the split loaders on the device), with the
process's resident set size printed before the first epoch and after each,
under one per-epoch action:

- ``none``: nothing (what a training run does),
- ``gc``: ``gc.collect()``,
- ``clear``: ``torch.cuda.empty_cache()`` and ``gc.collect()``: the
  port's counterpart of the JAX script's ``jax.clear_caches()`` (the port
  keeps no compiled-program cache to clear; the kernel library stays
  loaded), releasing the caching allocator's unused device blocks.

Prints one JSON line with the RSS series last; the host numbers are the
ones to read (``torch.cuda.max_memory_allocated`` is printed beside them
on the card).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
from typing import List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Host-RSS growth diagnostic for long training "
                                 "loops (PyTorch port)")
    ap.add_argument("--processed-dir", required=True)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--action", choices=("none", "gc", "clear"), default="none")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--variant", default="b0")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from .data import create_dataloaders
    from .device import resolve_device
    from .models.feature_extractor import create_model_from_config
    from .models.layers import init_weights
    from .training import Trainer, create_optimizer, make_criterion
    from .training.trainer import _rss_mb

    device = resolve_device(args.device)
    loaders = create_dataloaders(args.processed_dir, batch_size=args.batch_size, num_workers=2,
                                 device=device)
    model = init_weights(create_model_from_config(
        {"feature_extractor": {"variant": args.variant}, "classifier": {"hidden_dims": [32]}},
        dtype=torch.bfloat16), 0).to(device)
    opt = create_optimizer(model.parameters(), {"type": "AdamW", "lr": 1e-4}, gradient_clip=1.0)
    crit = make_criterion({"type": "CombinedLoss"})
    with tempfile.TemporaryDirectory(prefix="diag_rss_ckpt_") as save_dir:
        trainer = Trainer(
            model, opt, crit, train_loader=loaders["train"],
            val_loader=loaders.get("val", loaders["train"]), scheduler=None,
            config={"num_epochs": args.epochs, "gradient_clip": 1.0, "accumulation_steps": 1,
                    "use_amp": True, "remat": False, "early_stopping_patience": 10 ** 9,
                    "early_stopping_min_delta": 0.0, "save_freq": 10 ** 9,
                    "print_freq": 10 ** 9, "save_dir": save_dir, "max_keep": 1,
                    "save_best_only": True, "tb_dir": None})
        rss = [_rss_mb()]
        print(f"action={args.action} rss0={rss[0]:.0f}MB", flush=True)
        losses = []
        for epoch in range(args.epochs):
            tm = trainer.train_epoch(epoch)
            trainer.validate(epoch)
            if args.action == "gc":
                gc.collect()
            elif args.action == "clear":
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                gc.collect()
            rss.append(_rss_mb())
            losses.append(tm["loss"])
            peak = (f" device_peak={torch.cuda.max_memory_allocated(device) / 2 ** 20:.0f}MB"
                    if device.type == "cuda" else "")
            print(f"epoch {epoch}: rss={rss[-1]:.0f}MB loss={tm['loss']:.3f}{peak}", flush=True)
    growth = (rss[-1] - rss[1]) / max(len(rss) - 2, 1) if len(rss) > 2 else 0.0
    print(json.dumps({"action": args.action, "rss_mb": rss, "loss": losses,
                      "mb_per_epoch_after_first": growth}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
