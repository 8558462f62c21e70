"""Train / val / test split CSVs from the preprocessing results.

Counterpart of the JAX package's ``data/splits.py`` without pandas: the
rows ``processed`` marks true, grouped per (dataset, label) cell in the
order the values first appear, each cell shuffled with
``np.random.RandomState(seed).permutation(n)`` (the draw of pandas'
``DataFrame.sample(frac=1, random_state=seed)``), cut 70/15/15 by
``int(n · ratio)``, then each split shuffled once more the same way. The
same results give the same rows in the same order as the JAX function.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

import numpy as np

_TRUE = {"True", "true", "TRUE", "1", "1.0"}


def _shuffled(rows: List[Dict[str, Any]], seed: int) -> List[Dict[str, Any]]:
    return [rows[i] for i in np.random.RandomState(seed).permutation(len(rows))]


def _read_rows(results: Union[str, Path, Sequence[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    if isinstance(results, (str, Path)):
        with open(results, newline="") as f:
            return list(csv.DictReader(f))
    return [dict(r) for r in results]


def _cell(value: Any) -> str:
    """A value as its CSV cell (None and NaN as empty, as pandas writes them)."""
    if value is None or (isinstance(value, float) and value != value):
        return ""
    return str(value)


def create_data_splits(
    results: Union[str, Path, Sequence[Dict[str, Any]]],
    output_dir,
    train_ratio: float = 0.7,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    random_seed: int = 42,
    logger=None,
) -> Dict[str, List[Dict[str, Any]]]:
    """Write ``splits/{train,val,test}.csv`` under ``output_dir``.

    ``results``: the rows of the preprocessing results CSV, as a path or a
    sequence of dicts (column → value). Returns each split's rows in the
    order written.
    """
    rows = _read_rows(results)
    fields = list(rows[0]) if rows else []
    valid = [r for r in rows if str(r.get("processed")) in _TRUE]

    def first_seen(key):
        return list(dict.fromkeys(r[key] for r in valid))

    splits: Dict[str, List[Dict[str, Any]]] = {}
    for dataset in first_seen("dataset"):
        for label in first_seen("label"):
            subset = [r for r in valid if r["dataset"] == dataset and r["label"] == label]
            if not subset:
                continue
            subset = _shuffled(subset, random_seed)
            n = len(subset)
            train_end = int(n * train_ratio)
            val_end = train_end + int(n * val_ratio)
            for name, part in (("train", subset[:train_end]), ("val", subset[train_end:val_end]),
                               ("test", subset[val_end:])):
                splits.setdefault(name, []).extend(part)

    splits_dir = Path(output_dir) / "splits"
    splits_dir.mkdir(parents=True, exist_ok=True)
    final: Dict[str, List[Dict[str, Any]]] = {}
    for name, part in splits.items():
        part = _shuffled(part, random_seed)
        with open(splits_dir / f"{name}.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(fields)
            writer.writerows([_cell(r.get(k)) for k in fields] for r in part)
        final[name] = part
        if logger is not None:
            real = sum(r["label"] == "real" for r in part)
            fake = sum(r["label"] == "fake" for r in part)
            logger.info(f"{name} split: {len(part)} images (real {real} / fake {fake})")
    return final


__all__ = ["create_data_splits"]
