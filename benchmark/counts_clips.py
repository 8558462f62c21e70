"""Operations of a clip classifier, counted from the plain reference's
shapes as ``counts.py`` counts the per-face classifiers: two per
multiply-add of every convolution, linear layer and matrix product
(``FlopCounterMode`` over a forward on meta tensors), LayerNorm, GELU,
softmax and the CLS mean left out.

``clip_flops`` is one clip of T frames through the whole TimeSformer;
``temporal_flops`` the part of it in the temporal halves: per block the
QKV projection, QKᵀ, the weights times V, the output projection and
``Dense_td``, over each of the clip's patches' T frames.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .counts import _flops, _meta
from .reference import timesformer
from .reference.nn import Operands


@functools.lru_cache(maxsize=None)
def clip_flops(variant: str, image: int, frames: int, classes: int) -> float:
    """Operations of one clip of ``frames`` faces of ``image``²."""
    sd = _meta(timesformer.param_spec(variant, image, frames, classes))
    x = torch.ones((frames, image, image, 3), device="meta")
    return _flops(lambda: timesformer.forward(sd, x, variant, frames, Operands()))


@functools.lru_cache(maxsize=None)
def temporal_flops(variant: str, image: int, frames: int) -> float:
    """Operations of one clip's temporal halves, every block's."""
    c = timesformer.VARIANTS[variant]
    sd = _meta(timesformer.param_spec(variant, image, frames, 2))
    z = torch.ones((1, (image // c["patch"]) ** 2, frames, c["width"]), device="meta")
    return _flops(lambda: [timesformer.temporal(sd, f"block_{i}", z, c["heads"], Operands())
                           for i in range(c["depth"])])


def model_counts(model: dict, image: int) -> Tuple[float, float]:
    """(a clip's operations, its temporal halves' operations) for a
    configuration's ``model`` block at ``image``² faces."""
    fe, clf = model.get("feature_extractor", {}), model.get("classifier", {})
    variant, frames = fe.get("variant", "base16"), int(fe.get("num_frames", 8))
    return (clip_flops(variant, image, frames, clf.get("num_classes", 2)),
            temporal_flops(variant, image, frames))
