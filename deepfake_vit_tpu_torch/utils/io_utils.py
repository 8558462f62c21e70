"""Config, metrics and checkpoint files.

Counterpart of the JAX package's ``utils/io_utils.py`` (its JSON/YAML
config readers, ``save_metrics`` and the checkpoint functions): a
checkpoint is the flax msgpack file the JAX package writes
(``utils/msgpack.py``), saved atomically (``.tmp`` then rename), copied to
``best_model.ckpt`` when it is the best, and rotated by mtime keeping the
newest ``max_keep`` ``checkpoint_epoch_*.ckpt``. Either package reads the
other's files. YAML needs PyYAML, imported only when a YAML file is read.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from .msgpack import msgpack_restore, msgpack_serialize

PathLike = Union[str, Path]

CKPT_SUFFIX = ".ckpt"
BEST_NAME = f"best_model{CKPT_SUFFIX}"


def ensure_dir(path: PathLike) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def _json_default(obj: Any) -> Any:
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, Path):
        return str(obj)
    raise TypeError(f"not JSON serializable: {type(obj)}")


def load_json(path: PathLike) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_json(data: Any, path: PathLike, indent: int = 2) -> None:
    path = Path(path)
    ensure_dir(path.parent)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=indent, ensure_ascii=False, default=_json_default)


def load_config(path: PathLike) -> Dict[str, Any]:
    """Load a config file, dispatching on suffix (.yaml/.yml/.json)."""
    path = Path(path)
    if path.suffix in (".yaml", ".yml"):
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            return yaml.safe_load(f)
    if path.suffix == ".json":
        return load_json(path)
    raise ValueError(f"unsupported config format: {path.suffix}")


def save_metrics(metrics: Dict[str, Any], path: PathLike, append: bool = True) -> None:
    """Append-aware metrics JSON (a list of records, each with a timestamp)."""
    path = Path(path)
    records = []
    if append and path.exists():
        try:
            existing = load_json(path)
            records = existing if isinstance(existing, list) else [existing]
        except (json.JSONDecodeError, OSError):
            records = []
    entry = dict(metrics)
    entry.setdefault("timestamp", time.time())
    records.append(entry)
    save_json(records, path)


def _msgpackable(tree: Any) -> Any:
    """A tree of msgpack-friendly types: tensors to numpy, tuples to lists,
    numpy scalars to Python ones, anything unknown to its str (as the JAX
    function does)."""
    if isinstance(tree, dict):
        return {str(k): _msgpackable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_msgpackable(v) for v in tree]
    if isinstance(tree, Path):
        return str(tree)
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):  # torch.Tensor
        return tree.detach().cpu().numpy()
    if tree is None or isinstance(tree, (bool, int, float, str, bytes, np.ndarray)):
        return tree
    if isinstance(tree, np.integer):
        return int(tree)
    if isinstance(tree, np.floating):
        return float(tree)
    return str(tree)


def save_checkpoint(state: Dict[str, Any], save_dir: PathLike, filename: Optional[str] = None,
                    is_best: bool = False, max_keep: int = 5) -> Path:
    """Write ``state`` (epoch, params, batch_stats, opt_state, metrics, ...)
    to ``save_dir/checkpoint_epoch_{epoch:04d}.ckpt`` (or ``filename``);
    when ``is_best`` also to ``best_model.ckpt``; then keep the newest
    ``max_keep`` epoch checkpoints by mtime (the best copy is exempt).
    The trainer's ``opt_state`` is the torch optimizer's ``state_dict`` in
    numpy, not an optax state: the JAX package restores such a file with
    ``restore_opt=False``."""
    save_dir = ensure_dir(save_dir)
    if filename is None:
        filename = f"checkpoint_epoch_{state.get('epoch', 0):04d}{CKPT_SUFFIX}"
    path = save_dir / filename
    blob = msgpack_serialize(_msgpackable(state))
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
    tmp.replace(path)
    if is_best:
        shutil.copy2(path, save_dir / BEST_NAME)
    _rotate_checkpoints(save_dir, max_keep)
    return path


def _epoch_checkpoints(save_dir: Path):
    return sorted(save_dir.glob(f"checkpoint_epoch_*{CKPT_SUFFIX}"),
                  key=lambda p: p.stat().st_mtime)


def _rotate_checkpoints(save_dir: Path, max_keep: int) -> None:
    if max_keep is None or max_keep <= 0:
        return
    ckpts = _epoch_checkpoints(save_dir)
    for stale in ckpts[:-max_keep] if len(ckpts) > max_keep else []:
        stale.unlink(missing_ok=True)


def load_checkpoint(path: PathLike) -> Dict[str, Any]:
    """Load a checkpoint written by either package's ``save_checkpoint``."""
    return msgpack_restore(Path(path))


def latest_checkpoint(save_dir: PathLike) -> Optional[Path]:
    save_dir = Path(save_dir)
    if not save_dir.is_dir():
        return None
    ckpts = _epoch_checkpoints(save_dir)
    return ckpts[-1] if ckpts else None


__all__ = ["BEST_NAME", "CKPT_SUFFIX", "ensure_dir", "latest_checkpoint", "load_checkpoint",
           "load_config", "load_json", "save_checkpoint", "save_json", "save_metrics"]
