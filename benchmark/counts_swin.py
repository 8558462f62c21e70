"""Operations of the Swin classifier, counted from the plain reference's
shapes as ``counts.py`` counts the other classifiers: two per multiply-add
of every convolution, linear layer and matrix product (``FlopCounterMode``
over a forward on meta tensors); LayerNorm, GELU, softmax, the bias and
mask additions, the rolls and the token mean left out.

``face_flops`` is one face through the whole model; ``window_flops`` the
part of it in the window halves: per block the QKV projection, QKᵀ, the
weights times V and the output projection, over every window.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .counts import _flops, _meta
from .reference import swin
from .reference.nn import Operands


@functools.lru_cache(maxsize=None)
def face_flops(variant: str, image: int, classes: int) -> float:
    """Operations of one face of ``image``²."""
    sd = _meta(swin.param_spec(variant, image, classes))
    x = torch.ones((1, image, image, 3), device="meta")
    return _flops(lambda: swin.forward(sd, x, variant, Operands()))


@functools.lru_cache(maxsize=None)
def window_flops(variant: str, image: int) -> float:
    """Operations of one face's window halves, every block's."""
    sd = _meta(swin.param_spec(variant, image, 2))
    calls = []
    for s, st in enumerate(swin.stages(variant, image)):
        h = torch.ones((1, st["res"], st["res"], st["width"]), device="meta")
        for i in range(st["depth"]):
            calls.append((f"stage_{s}.block_{i}", h, st, st["shift"] if i % 2 else 0))
    return _flops(lambda: [swin.window_attention(sd, p, h, st, shift, Operands())
                           for p, h, st, shift in calls])


def model_counts(model: dict, image: int) -> Tuple[float, float]:
    """(a face's operations, its window halves' operations) for a
    configuration's ``model`` block at ``image``² faces."""
    fe, clf = model.get("feature_extractor", {}), model.get("classifier", {})
    variant = fe.get("variant", "base4w7")
    return face_flops(variant, image, clf.get("num_classes", 2)), window_flops(variant, image)
