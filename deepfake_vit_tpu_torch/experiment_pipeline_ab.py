"""Paired-seed end-task A/B over any pipeline knob.

    python -m deepfake_vit_tpu_torch.experiment_pipeline_ab --workdir DIR
        --arm NAME KEY=VAL [KEY=VAL ...] --arm NAME KEY=VAL [...]
        [--n-per-class 600] [--size 320] [--epochs 35] [--batch-size 32] [--lr 3e-4]
        [--seed 42] [--train-seeds 42,...,49] [--variant b0] [--face-size 224]
        [--cache device|none] [--skip-render] [--quiet-children] [--device cuda|cpu]

The flags of the JAX package's ``scripts/experiment_pipeline_ab.py``,
plus ``--device``, passed on to every child. The protocol:

1. render one labeled corpus (``data/synth_faces.py``),
2. preprocess it once for each distinct set of ``pre:`` overrides through
   ``python -m deepfake_vit_tpu_torch.preprocess_dataset`` (arms with the
   same preprocessing share one processed directory),
3. for each training seed (the outer loop), train and evaluate both arms
   through the port's ``train`` and ``evaluate`` CLIs,
4. rewrite ``{workdir}/summary.json`` after every seed with the paired
   ΔAUC (treat − control) and its 95 % t-CI, so that an interrupted run
   still leaves a poolable partial result (``aggregate_ablation``).

Arms (first control, then treat) take overrides ``pre:<dotted.path>=<yaml
value>`` (preprocessing config), ``model:<dotted.path>=<yaml value>``
(training config) and the shorthand ``face_size=<int>``, which sets both
``pre:alignment.output_size`` and ``model:data.image_size``.

The deltas are taken per training seed from each arm's own result for
that seed (``delta_seeds``); a seed is skipped only when either arm's AUC
is missing. The JAX script drops each arm's missing AUCs on its own and
zips the two lists, which pairs the wrong seeds after a gap.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from .experiment_attention_ablation import (Runner, agg, delta_stats, device_args, paired_deltas,
                                            preprocessing_config, read_metrics, render_corpus, run,
                                            train_and_evaluate, training_config, write_json)


def _parse_value(s: str):
    import yaml

    return yaml.safe_load(s)


def _set_dotted(cfg: dict, dotted: str, value) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


class Arm:
    def __init__(self, name: str, tokens: Sequence[str]):
        self.name = name
        self.pre: dict = {}
        self.model: dict = {}
        self.processed: Optional[Path] = None
        for tok in tokens:
            if "=" not in tok:
                raise SystemExit(f"arm {name}: bad override {tok!r} (want key=value)")
            key, _, val = tok.partition("=")
            val = _parse_value(val)
            if key == "face_size":
                self.pre["alignment.output_size"] = [int(val), int(val)]
                self.model["data.image_size"] = int(val)
            elif key.startswith("pre:"):
                self.pre[key[4:]] = val
            elif key.startswith("model:"):
                self.model[key[6:]] = val
            else:
                raise SystemExit(f"arm {name}: override {key!r} needs a pre:/model: prefix "
                                 "(or the face_size shorthand)")

    @property
    def pre_key(self) -> str:
        return json.dumps(sorted(self.pre.items()))


def summarize(control: Arm, treat: Arm, results: Dict[str, Dict[int, Dict[str, Any]]],
              train_seeds: Sequence[int], meta: Dict[str, Any]) -> Dict[str, Any]:
    """The summary over the seeds both arms have finished (JAX schema,
    deltas paired by seed)."""
    done = [s for s in train_seeds if s in results[control.name] and s in results[treat.name]]
    seeds, deltas = paired_deltas(results[treat.name], results[control.name], done)
    return {
        "control": control.name,
        "treat": treat.name,
        "overrides": {control.name: {**control.pre, **control.model},
                      treat.name: {**treat.pre, **treat.model}},
        "auc_control": agg(results[control.name], "roc_auc", done),
        "auc_treat": agg(results[treat.name], "roc_auc", done),
        "acc_control": agg(results[control.name], "accuracy", done),
        "acc_treat": agg(results[treat.name], "accuracy", done),
        **delta_stats(deltas),
        "delta_seeds": seeds,
        "train_seeds": done,
        **meta,
    }


def main(argv: Optional[List[str]] = None, runner: Runner = run) -> int:
    parser = argparse.ArgumentParser(description="Paired-seed end-task A/B over any pipeline "
                                     "knob (PyTorch port)")
    parser.add_argument("--workdir", type=str, required=True)
    parser.add_argument("--arm", nargs="+", action="append", required=True,
                        metavar=("NAME", "KEY=VAL"),
                        help="arm name + overrides; give exactly twice (control, then treat)")
    parser.add_argument("--n-per-class", type=int, default=600)
    parser.add_argument("--size", type=int, default=320,
                        help="rendered scene side (= detection canvas)")
    parser.add_argument("--epochs", type=int, default=35)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=42, help="corpus/render seed")
    parser.add_argument("--train-seeds", type=str, default="42,43,44,45,46,47,48,49")
    parser.add_argument("--variant", type=str, default="b0")
    parser.add_argument("--face-size", type=int, default=224,
                        help="default aligned-face side (arms may override)")
    parser.add_argument("--cache", type=str, default="device", choices=["device", "none"],
                        help="data-loader cache mode for train/eval runs")
    parser.add_argument("--skip-render", action="store_true")
    parser.add_argument("--quiet-children", action="store_true",
                        help="redirect train/eval child output to per-run logs")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of every child (default: the card)")
    args = parser.parse_args(argv)

    from .device import resolve_device

    resolve_device(args.device)  # the card, or raise before any work
    arms = [Arm(a[0], a[1:]) for a in args.arm]
    if len(arms) != 2:
        raise SystemExit("exactly two --arm declarations required (control, treat)")
    control, treat = arms
    train_seeds = [int(x) for x in args.train_seeds.split(",")]

    ws = Path(args.workdir)
    ws.mkdir(parents=True, exist_ok=True)
    raw = ws / "raw"
    if not args.skip_render and not (raw / "real").exists():
        render_corpus(raw, args.n_per_class, args.size, args.seed)

    processed_for: Dict[str, Path] = {}
    for arm in arms:
        if arm.pre_key not in processed_for:
            processed = ws / f"processed_{arm.name}"
            pre = preprocessing_config(raw, processed, ws / "logs", args.size, args.face_size)
            for k, v in arm.pre.items():
                _set_dotted(pre, k, v)
            pre_cfg = write_json(pre, ws / f"pre_{arm.name}.json")
            if not (processed / "splits" / "train.csv").exists():
                runner("preprocess_dataset", ["--config", pre_cfg, "--datasets", "gen_ai",
                                              *device_args(args.device)])
            processed_for[arm.pre_key] = processed
        arm.processed = processed_for[arm.pre_key]

    results: Dict[str, Dict[int, Dict[str, Any]]] = {arm.name: {} for arm in arms}
    meta = {"n_per_class": args.n_per_class, "epochs": args.epochs, "variant": args.variant,
            "face_size": args.face_size}

    def run_one(arm: Arm, tseed: int) -> Dict[str, Any]:
        tag = f"{arm.name}_s{tseed}"
        eval_json = ws / f"eval_{tag}" / "eval_test.json"
        if eval_json.exists():
            metrics = read_metrics(eval_json)
        else:
            cfg = training_config(ws, tag, arm.processed, args.variant, args.batch_size,
                                  args.epochs, args.lr, tseed)
            cfg["data"]["image_size"] = args.face_size
            if args.cache != "none":
                cfg["data"]["cache"] = args.cache
            for k, v in arm.model.items():
                _set_dotted(cfg, k, v)
            cfg_path = write_json(cfg, ws / f"model_{tag}.json")
            log = (ws / f"log_{tag}.txt") if args.quiet_children else None
            metrics = train_and_evaluate(runner, ws, tag, cfg_path, args.device, log)
        metrics["train_seed"] = tseed
        return metrics

    summary: Dict[str, Any] = {}
    for tseed in train_seeds:
        for arm in arms:
            results[arm.name][tseed] = run_one(arm, tseed)
        summary = summarize(control, treat, results, train_seeds, meta)
        write_json(summary, ws / "summary.json")
        ci = summary["delta_auc_ci95"]
        mean = summary["delta_auc_mean"]
        print(f"[{len(summary['train_seeds'])}/{len(train_seeds)} seeds] "
              f"dAUC({treat.name}-{control.name}) "
              + (f"mean={mean:+.4f}" if mean is not None else "mean=n/a")
              + (f" CI95=[{ci[0]:+.4f}, {ci[1]:+.4f}]" if ci else ""),
              file=sys.stderr, flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
