"""Measure the spread behind ``chip_smoke.py``'s train-step limits over
several seeded batches, on one NVIDIA GPU.

    python3 deepfake_vit_tpu_torch/tools/train_gates.py [--seeds 22 24 25 27 29]

For each seed, 4 of ``chip_smoke.train_faces`` and the B4 of the training
configuration at 224² (dropout and drop-connect off):

- the whole AdamW step on the card in float32 (TF32 off) and in bf16, and
  on the CPU in bf16, each against the CPU's float32 step
  (``compare_steps``);
- the yardstick of the float32 gate: the card's and the CPU's float32
  steps each against a float64 step of the same batch on the CPU, whole
  (``compare_steps``) and leaf by leaf (``leaf_gaps``: the leaves where
  the card is farthest from float64, with the CPU's gap beside them);
- the bf16 step piece by piece (``bf16_pieces``) and its controls: every
  convolution's output and gradient at 7, 6 and 5 significant bits, and
  BatchNorm computed in bf16.

For the first seed also the whole bf16 step at batch 32, and at batch 4
with ``freeze_bn`` (the backbone's BatchNorm on its running statistics).
Then the optimizer alone, card against CPU, with and without weight
decay (``optimizer_card_vs_cpu``). Prints the card, one line a
measurement, and one JSON line with every number; exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))  # run as a script from anywhere


def load_chip_smoke():
    """chip_smoke.py of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[22, 24, 25, 27, 29])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from deepfake_vit_tpu_torch.configs import TRAINING_CONFIG

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["model"]["feature_extractor"]["dropout_rate"] = 0.0
    cfg["model"]["classifier"]["dropout_rate"] = 0.0
    lr = cfg["training"]["optimizer"]["lr"]
    short = lambda d: {k: float(f"{v:.4g}") for k, v in d.items()}  # noqa: E731
    out = {"card": card, "optimizer_lr": cs.optimizer_card_vs_cpu(dev),
           "optimizer_without_decay_lr": cs.optimizer_card_vs_cpu(dev, 0.0), "batches": {}}
    print(f"optimizer card vs CPU {out['optimizer_lr']:.4g} lr, without weight decay "
          f"{out['optimizer_without_decay_lr']:.4g} lr")
    for seed in args.seeds:
        batch = cs.train_faces(4, seed)
        want = cs.one_train_step(cfg, torch.float32, "cpu", batch)
        with cs.tf32_off():
            steps = {"card float32": cs.one_train_step(cfg, torch.float32, dev, batch)}
        f64 = cs.one_train_step(cfg, torch.float64, "cpu", batch)
        row = {f"float32 vs float64, {k}": cs.compare_steps(v, f64, lr)
               for k, v in (("card", steps["card float32"]), ("CPU", want))}
        card_leaf, cpu_leaf = (cs.leaf_gaps(v, f64) for v in (steps["card float32"], want))
        worst = sorted(card_leaf, key=card_leaf.get, reverse=True)[:5]
        out.setdefault("leaves", {})[seed] = {k: (card_leaf[k], cpu_leaf[k]) for k in worst}
        for k in worst:
            print(f"seed {seed}, leaf {k}: card {card_leaf[k]:.4g}, CPU {cpu_leaf[k]:.4g} "
                  "of the largest float64 gradient")
        steps["card bf16"] = cs.one_train_step(cfg, torch.bfloat16, dev, batch)
        steps["CPU bf16"] = cs.one_train_step(cfg, torch.bfloat16, "cpu", batch)
        row.update({f"whole step, {k}": cs.compare_steps(v, want, lr) for k, v in steps.items()})
        for name, kw in (("bf16", {}), ("7 bits", {"round_bits": 7}),
                         ("6 bits", {"round_bits": 6}), ("5 bits", {"round_bits": 5}),
                         ("BatchNorm in bf16", {"fault": cs.bn_in_input_dtype})):
            row[f"pieces, {name}"] = cs.bf16_pieces(cfg, dev, batch, **kw)
        if seed == args.seeds[0]:
            frozen = copy.deepcopy(cfg)
            frozen["model"]["feature_extractor"]["freeze_bn"] = True
            for name, c, b in (("batch 32", cfg, cs.train_faces(32, seed)),
                               ("freeze_bn", frozen, batch)):
                row[f"whole step, card bf16, {name}"] = cs.compare_steps(
                    cs.one_train_step(c, torch.bfloat16, dev, b),
                    cs.one_train_step(c, torch.float32, "cpu", b), lr)
        for k, v in row.items():
            print(f"seed {seed}, {k}: {short(v)}")
        out["batches"][seed] = row
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
