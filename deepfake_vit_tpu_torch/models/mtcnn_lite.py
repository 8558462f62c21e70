"""MTCNN-Lite: the light detector family of depthwise-separable blocks.

Counterpart of the JAX package's ``models/mtcnn_lite.py``: a stride-4
stem (3×3 s2 conv, then a depthwise-separable s2 block), three stages of
two depthwise-separable blocks (strides 8, 16, 32), a 1×1-lateral FPN
without smoothing, and one head shared over the levels (a
depthwise-separable tower, then 3×3 cls, box and kps convs). Same output
contract as ``ScrfdDetector``: per stride in {8, 16, 32}, ``scores``
(B, N_l), ``bbox`` (B, N_l, 4) and ``kps`` (B, N_l, 10), 2 anchors per
location. BatchNorm momentum 0.9, eps 1e-5, as in the flax module.

Submodules carry the flax tree keys (``stem``, ``stem_bn``, ``ds0``,
``ds1a``/``ds1b``, ``dw``/``dw_bn``/``pw``/``pw_bn``, ``lat3``-``lat5``,
``head/tower``, ``cls``), so ``models/bridge.py`` loads the committed
``mtcnn_lite_synface.msgpack`` strictly.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import NUM_ANCHORS, STRIDES
from .layers import BatchNorm, Conv
from .scrfd import _BN_EPS, _BN_MOMENTUM, _upsample2


class _DsBlock(nn.Module):
    """Depthwise 3×3 (stride s) + BN + ReLU, then pointwise 1×1 + BN + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.dw = Conv(cin, cin, 3, stride, groups=cin)
        self.dw_bn = BatchNorm(cin, _BN_EPS, _BN_MOMENTUM)
        self.pw = Conv(cin, features, 1)
        self.pw_bn = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dw_bn(self.dw(x)))
        return F.relu(self.pw_bn(self.pw(x)))


class _LiteHead(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.tower = _DsBlock(width, width, 1)
        self.cls = Conv(width, NUM_ANCHORS, 3, bias=True)
        self.box = Conv(width, 4 * NUM_ANCHORS, 3, bias=True)
        self.kps = Conv(width, 10 * NUM_ANCHORS, 3, bias=True)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = x.shape[0]
        x = self.tower(x)

        wide = torch.promote_types(x.dtype, torch.float32)  # float64 stays

        def flat(y: torch.Tensor, k: int) -> torch.Tensor:
            # NHWC row-major, then anchor.
            return y.permute(0, 2, 3, 1).reshape(B, -1, k).to(wide)

        return {"scores": flat(self.cls(x), 1)[..., 0], "bbox": flat(self.box(x), 4),
                "kps": flat(self.kps(x), 10)}


class MtcnnLiteDetector(nn.Module):
    """``forward(images)`` with images (B, H, W, 3) normalized
    ((x−127.5)/128), H and W multiples of 32, returns the
    ``ScrfdDetector`` output dict, float32."""

    def __init__(self, widths: Sequence[int] = (16, 32, 48, 64), fpn_width: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(3, widths[0], 3, 2)
        self.stem_bn = BatchNorm(widths[0], _BN_EPS, _BN_MOMENTUM)
        self.ds0 = _DsBlock(widths[0], widths[0], 2)
        cin = widths[0]
        for i, w in enumerate(widths[1:], start=1):
            self.add_module(f"ds{i}a", _DsBlock(cin, w, 2))
            self.add_module(f"ds{i}b", _DsBlock(w, w, 1))
            cin = w
        c3, c4, c5 = widths[1:]
        self.lat5 = Conv(c5, fpn_width, 1, bias=True)
        self.lat4 = Conv(c4, fpn_width, 1, bias=True)
        self.lat3 = Conv(c3, fpn_width, 1, bias=True)
        self.head = _LiteHead(fpn_width)
        self.n_stages = len(widths) - 1

    def forward(self, images: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self.ds0(F.relu(self.stem_bn(self.stem(x))))
        feats = []
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"ds{i}b")(getattr(self, f"ds{i}a")(x))
            feats.append(x)  # strides 8, 16, 32
        c3, c4, c5 = feats
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _upsample2(p5)
        p3 = self.lat3(c3) + _upsample2(p4)
        return {stride: self.head(feat) for stride, feat in zip(STRIDES, (p3, p4, p5))}


__all__ = ["MtcnnLiteDetector"]
