"""Detection-network factory and the committed detector weights.

The weights are the JAX package's in-framework-trained flax msgpack file,
read by path (``utils/msgpack.py``) and carried across by
``models/bridge.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from ..models.lite_detector import LiteDetector
from ..models.scrfd import ScrfdDetector

_WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "deepfake_vit_tpu" / "weights"
DEFAULT_WEIGHTS_BY_MODEL = {"scrfd": _WEIGHTS_DIR / "scrfd_synface.msgpack",
                            "lite": _WEIGHTS_DIR / "lite_synface.msgpack"}


def default_weights_path(model: str = "scrfd") -> Optional[str]:
    """Path to the committed detector weights, or None if absent."""
    p = DEFAULT_WEIGHTS_BY_MODEL.get(model)
    return str(p) if p is not None and p.exists() else None


def build_detection_net(model: str = "scrfd", dtype: torch.dtype = torch.float32,
                        stem_pool: int = 1) -> Union[ScrfdDetector, LiteDetector]:
    """Detection net factory: 'scrfd' (alias 'retinaface') and 'lite'.
    ``stem_pool=p`` builds the network that takes p·canvas frames and folds
    the p× average pool into its first conv."""
    if model in ("scrfd", "retinaface"):
        return ScrfdDetector(dtype=dtype, stem_pool=stem_pool)
    if model == "lite":
        return LiteDetector(dtype=dtype, stem_pool=stem_pool)
    raise NotImplementedError(
        f"detector {model!r} is not ported yet (the mtcnn and hog families are still to "
        "port, ROADMAP Queue A item 10); 'scrfd' and 'lite' are"
    )
