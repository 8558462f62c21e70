"""End-to-end training-to-AUC experiment with an attention ablation.

    python -m deepfake_vit_tpu_torch.experiment_attention_ablation [--workdir DIR]
        [--n-per-class 600] [--size 320] [--epochs 35] [--batch-size 32] [--lr 3e-4]
        [--seed 42] [--train-seeds 42,43,44] [--variant b0] [--face-size 224]
        [--skip-render] [--skip-preprocess] [--device cuda|cpu]

The flags of the JAX package's ``scripts/experiment_attention_ablation.py``,
plus ``--device``, passed on to every child. It drives the port's own
entry points end to end:

1. renders a raw real/fake corpus (``data/synth_faces.py::
   write_classification_corpus``: "fake" is the same face with localized
   artifacts at landmark regions),
2. ``python -m deepfake_vit_tpu_torch.preprocess_dataset`` (the committed
   SCRFD at the render size, confidence 0.3, alignment to ``--face-size``),
3. ``python -m deepfake_vit_tpu_torch.train`` for each arm and training
   seed from one config template: full hybrid attention against the
   ablation (no landmark, spatial or channel attention), the same corpus
   and splits,
4. ``python -m deepfake_vit_tpu_torch.evaluate`` on the shared test split.

The summary (printed as one JSON line and written to
``{workdir}/summary.json``) has the JAX script's schema, so
``aggregate_ablation`` pools summaries of either package. Each arm's
``per_seed`` lists the AUCs it has; ``delta_auc_per_seed`` pairs the two
arms **by training seed** (``delta_seeds``): a seed whose AUC is missing in
either arm is skipped. The JAX script filters each arm's missing AUCs on
its own and zips the two lists, which pairs the wrong seeds after a gap.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
Runner = Callable[..., None]

# Two-sided 97.5 % t quantiles for 1..29 degrees of freedom, used where
# scipy is missing (the JAX script's table).
_T_TABLE = [12.71, 4.30, 3.18, 2.78, 2.57, 2.45, 2.36, 2.31, 2.26, 2.23,
            2.20, 2.18, 2.16, 2.14, 2.13, 2.12, 2.11, 2.10, 2.09, 2.09,
            2.08, 2.07, 2.07, 2.06, 2.06, 2.06, 2.05, 2.05, 2.05]


def _paired_ci95(deltas: Sequence[float]) -> Optional[List[float]]:
    """95 % CI on the mean paired ΔAUC (t-distribution, n − 1 dof)."""
    n = len(deltas)
    if n < 2:
        return None
    mean = statistics.mean(deltas)
    se = statistics.stdev(deltas) / n ** 0.5
    try:
        from scipy.stats import t

        q = float(t.ppf(0.975, n - 1))
    except ImportError:
        q = _T_TABLE[min(n - 2, len(_T_TABLE) - 1)]
    return [mean - q * se, mean + q * se]


def run(module: str, args: Sequence[Any], log_path: Optional[Path] = None) -> None:
    """``python -m deepfake_vit_tpu_torch.<module> *args`` in a child
    process (its output appended to ``log_path`` when given); raises if it
    fails."""
    cmd = [sys.executable, "-m", f"deepfake_vit_tpu_torch.{module}", *map(str, args)]
    print(f"+ {' '.join(cmd)}", file=sys.stderr, flush=True)
    if log_path:
        with open(log_path, "a") as f:
            subprocess.run(cmd, check=True, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    else:
        subprocess.run(cmd, check=True, cwd=ROOT)


def run_in_process(module: str, args: Sequence[Any], log_path: Optional[Path] = None) -> None:
    """The CLI's ``main(argv)`` in this process; raises on a non-zero return."""
    print(f"+ deepfake_vit_tpu_torch.{module} {' '.join(map(str, args))}", file=sys.stderr,
          flush=True)
    rc = importlib.import_module(f"deepfake_vit_tpu_torch.{module}").main(list(map(str, args)))
    if rc:
        raise RuntimeError(f"deepfake_vit_tpu_torch.{module} returned {rc}")


def device_args(device: Optional[str]) -> List[str]:
    return [] if device is None else ["--device", device]


def render_corpus(raw: Path, n_per_class: int, size: int, seed: int) -> None:
    from .data.synth_faces import write_classification_corpus

    print(f"rendering {2 * n_per_class} labeled faces -> {raw}", file=sys.stderr)
    write_classification_corpus(raw, n_per_class, size=size, seed=seed)


def preprocessing_config(raw: Path, processed: Path, logs: Path, size: int,
                         face_size: int) -> Dict[str, Any]:
    """The packaged preprocessing config with the experiment's edits."""
    from .configs import PREPROCESSING_CONFIG

    pre = copy.deepcopy(PREPROCESSING_CONFIG)
    pre["detection"]["scrfd"]["input_size"] = [size, size]
    pre["detection"]["confidence_threshold"] = 0.3
    pre["alignment"]["output_size"] = [face_size, face_size]
    pre["datasets"]["gen_ai"]["path"] = str(raw)
    pre["output"]["base_dir"] = str(processed)
    pre["logging"]["log_dir"] = str(logs)
    return pre


def training_config(ws: Path, tag: str, processed: Path, variant: str, batch_size: int,
                    epochs: int, lr: float, seed: int) -> Dict[str, Any]:
    """The packaged training config with the experiment's edits."""
    from .configs import TRAINING_CONFIG

    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["model"]["feature_extractor"]["variant"] = variant
    cfg["data"]["processed_dir"] = str(processed)
    cfg["data"]["batch_size"] = batch_size
    cfg["training"]["num_epochs"] = epochs
    cfg["training"]["optimizer"]["lr"] = lr
    cfg["seed"] = seed
    cfg.setdefault("checkpoint", {})["save_dir"] = str(ws / f"ckpt_{tag}")
    cfg.setdefault("validation", {})["save_freq"] = max(epochs // 2, 1)
    cfg.setdefault("logging", {})["log_dir"] = str(ws / f"runs_{tag}")
    cfg["early_stopping"] = {"patience": epochs}  # run all epochs
    return cfg


def write_json(obj: Any, path: Path) -> Path:
    path.write_text(json.dumps(obj, indent=2))
    return path


def train_and_evaluate(runner: Runner, ws: Path, tag: str, cfg_path: Path,
                       device: Optional[str], log_path: Optional[Path] = None) -> Dict[str, Any]:
    """Train one arm/seed, evaluate its best checkpoint on the test split;
    the latest metrics ``evaluate`` appended to ``eval_test.json``."""
    out_dir = ws / f"eval_{tag}"
    runner("train", ["--config", cfg_path, *device_args(device)], log_path)
    runner("evaluate", ["--checkpoint", ws / f"ckpt_{tag}" / "best_model.ckpt",
                        "--config", cfg_path, "--output-dir", out_dir, *device_args(device)],
           log_path)
    return read_metrics(out_dir / "eval_test.json")


def read_metrics(path: Path) -> Dict[str, Any]:
    metrics = json.loads(path.read_text())
    return metrics[-1] if isinstance(metrics, list) else metrics  # appended: take the latest


def agg(by_seed: Dict[int, Dict[str, Any]], key: str, seeds: Sequence[int]) -> Dict[str, Any]:
    """Mean, std and the values of ``key`` over ``seeds``, missing ones left out."""
    vals = [by_seed[s].get(key) for s in seeds if s in by_seed]
    vals = [v for v in vals if v is not None]
    if not vals:
        return {"mean": None, "std": None, "per_seed": []}
    return {"mean": statistics.mean(vals), "std": statistics.stdev(vals) if len(vals) > 1 else 0.0,
            "per_seed": vals}


def paired_deltas(treat: Dict[int, Dict[str, Any]], control: Dict[int, Dict[str, Any]],
                  seeds: Sequence[int], key: str = "roc_auc"):
    """(seeds, treat − control) over the seeds where both arms have ``key``."""
    pairs = [(s, treat[s][key] - control[s][key]) for s in seeds
             if s in treat and s in control
             and treat[s].get(key) is not None and control[s].get(key) is not None]
    return [s for s, _ in pairs], [d for _, d in pairs]


def delta_stats(deltas: Sequence[float]) -> Dict[str, Any]:
    return {"delta_auc_mean": statistics.mean(deltas) if deltas else None,
            "delta_auc_std": statistics.stdev(deltas) if len(deltas) > 1 else 0.0,
            "delta_auc_ci95": _paired_ci95(deltas),
            "delta_auc_per_seed": list(deltas)}


def summarize(results: Dict[str, Dict[int, Dict[str, Any]]], train_seeds: Sequence[int],
              meta: Dict[str, Any]) -> Dict[str, Any]:
    """The summary of the two arms' per-seed metrics (JAX schema, paired by seed)."""
    seeds, deltas = paired_deltas(results["attention"], results["ablation"], train_seeds)
    return {
        "auc_attention": agg(results["attention"], "roc_auc", train_seeds),
        "auc_ablation": agg(results["ablation"], "roc_auc", train_seeds),
        "acc_attention": agg(results["attention"], "accuracy", train_seeds),
        "acc_ablation": agg(results["ablation"], "accuracy", train_seeds),
        **delta_stats(deltas),
        "delta_seeds": seeds,
        "train_seeds": list(train_seeds),
        **meta,
    }


def main(argv: Optional[List[str]] = None, runner: Runner = run) -> int:
    parser = argparse.ArgumentParser(description="AUC + attention ablation experiment "
                                     "(PyTorch port)")
    parser.add_argument("--workdir", type=str, default="outputs/ablation_experiment")
    parser.add_argument("--n-per-class", type=int, default=600)
    parser.add_argument("--size", type=int, default=320)
    parser.add_argument("--epochs", type=int, default=35)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=42,
                        help="corpus/render seed (data is fixed across training seeds)")
    parser.add_argument("--train-seeds", type=str, default=None,
                        help="comma-separated training seeds; each arm runs once per seed "
                        "on the same data")
    parser.add_argument("--variant", type=str, default="b0")
    parser.add_argument("--face-size", type=int, default=224,
                        help="aligned-face side fed to the classifier")
    parser.add_argument("--skip-render", action="store_true")
    parser.add_argument("--skip-preprocess", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of every child (default: the card)")
    args = parser.parse_args(argv)

    from .device import resolve_device

    resolve_device(args.device)  # the card, or raise before any work
    ws = Path(args.workdir)
    ws.mkdir(parents=True, exist_ok=True)
    raw, processed = ws / "raw", ws / "processed"

    if not args.skip_render:
        render_corpus(raw, args.n_per_class, args.size, args.seed)
    pre_cfg = write_json(preprocessing_config(raw, processed, ws / "logs", args.size,
                                              args.face_size), ws / "pre.json")
    if not args.skip_preprocess:
        runner("preprocess_dataset", ["--config", pre_cfg, "--datasets", "gen_ai",
                                      *device_args(args.device)])

    train_seeds = ([int(x) for x in args.train_seeds.split(",")] if args.train_seeds
                   else [args.seed])
    results: Dict[str, Dict[int, Dict[str, Any]]] = {"attention": {}, "ablation": {}}
    for arm, use_landmark in (("attention", True), ("ablation", False)):
        for tseed in train_seeds:
            tag = f"{arm}_s{tseed}" if len(train_seeds) > 1 else arm
            cfg = training_config(ws, tag, processed, args.variant, args.batch_size,
                                  args.epochs, args.lr, tseed)
            att = cfg["model"]["feature_extractor"]["attention_config"]
            att["use_landmark"] = use_landmark
            if not use_landmark:  # the full ablation: no landmark-derived signal anywhere
                att["use_spatial"] = att["use_channel"] = False
                cfg["model"]["feature_extractor"]["use_attention"] = False
            cfg_path = write_json(cfg, ws / f"model_{tag}.json")
            metrics = train_and_evaluate(runner, ws, tag, cfg_path, args.device)
            metrics["train_seed"] = tseed
            results[arm][tseed] = metrics

    summary = summarize(results, train_seeds, {
        "n_per_class": args.n_per_class, "epochs": args.epochs, "variant": args.variant,
        "face_size": args.face_size})
    print(json.dumps(summary))
    write_json(summary, ws / "summary.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
