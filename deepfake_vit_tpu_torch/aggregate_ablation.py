"""Pool attention-ablation runs into one paired ΔAUC analysis.

    python -m deepfake_vit_tpu_torch.aggregate_ablation SUMMARY.json SUMMARY.json [...]

The JAX package's ``scripts/aggregate_ablation.py``. Each input is a
summary JSON of either package's ``experiment_attention_ablation`` (keys
``auc_attention`` / ``auc_ablation``) or ``experiment_pipeline_ab``
(``auc_treat`` / ``auc_control``); in both, the delta is the first minus
the second. Runs are poolable because pairing is within a training seed
and the seeds of two runs must not overlap. Prints one JSON object with
the paired 95 % CI (t-distribution) of the mean ΔAUC. Host-only: no
device is touched.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

from .experiment_attention_ablation import _paired_ci95


def pool(paths: Sequence[Union[str, Path]]) -> Dict[str, Any]:
    seeds: List[int] = []
    deltas: List[float] = []
    att: List[float] = []
    abl: List[float] = []
    for p in paths:
        s = json.loads(Path(p).read_text())
        run_seeds = s["train_seeds"]
        if set(run_seeds) & set(seeds):
            raise SystemExit(f"{p}: train seeds {run_seeds} overlap an earlier run; "
                             "pairs must be independent")
        seeds += run_seeds
        deltas += s["delta_auc_per_seed"]
        a = s.get("auc_attention") or s["auc_treat"]
        b = s.get("auc_ablation") or s["auc_control"]
        att += a["per_seed"]
        abl += b["per_seed"]
    lo, hi = _paired_ci95(deltas)
    return {
        "n_pairs": len(deltas),
        "train_seeds": seeds,
        "auc_attention_mean": statistics.mean(att),
        "auc_ablation_mean": statistics.mean(abl),
        "delta_auc_mean": statistics.mean(deltas),
        "delta_auc_std": statistics.stdev(deltas),
        "delta_auc_ci95": [lo, hi],
        "delta_auc_per_seed": deltas,
        "separable_from_zero": bool(lo > 0.0 or hi < 0.0),
    }


def main(argv: Sequence[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        raise SystemExit(__doc__)
    print(json.dumps(pool(argv), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
