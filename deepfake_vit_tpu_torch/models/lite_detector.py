"""S2D-Lite face detector: a 4× space-to-depth rearrangement up front, then
dense 3×3 convs only (a stride-4 trunk, three stride-2 stages), a
1×1-lateral FPN with 3×3 smooth convs and the SCRFD head shared over the
levels. Same output contract as ``ScrfdDetector``: per stride in {8, 16,
32}, ``scores`` (B, N_l), ``bbox`` (B, N_l, 4) and ``kps`` (B, N_l, 10),
2 anchors per location.

Submodules carry the flax tree keys (``conv1``, ``down1``, ``lat5``,
``smooth0``, ``head/tower0``) so ``models/bridge.py`` loads the committed
``lite_synface.msgpack`` mechanically. With ``stem_pool=p`` the network
takes p·canvas frames: the space-to-depth factor becomes 4p and the first
conv gathers each fine channel's coarse weight divided by p², which gives
pool-then-detect exactly (``fold_stem_pool_params_lite``). As with the
SCRFD stem, the module keeps the unfolded flax weight and expands it at
use, so the flax tree loads strictly whatever ``stem_pool`` is.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import STRIDES
from .layers import Conv
from .scrfd import _ConvBN, _ScrfdHead, _upsample2


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H/f, W/f, f·f·C), channel c = (a·f + b)·C + rgb
    where (a, b) is the position inside the f×f block."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // f, f, W // f, f, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // f, W // f, f * f * C)


def _fine_to_coarse(pool: int, s2d: int) -> np.ndarray:
    """For each channel of space_to_depth(·, s2d·pool), the channel of
    space_to_depth(·, s2d) on the pooled image that averages it."""
    f0, f1 = s2d, s2d * pool
    a1, b1 = np.meshgrid(np.arange(f1), np.arange(f1), indexing="ij")
    coarse = (a1 // pool) * f0 + (b1 // pool)
    return (coarse[..., None] * 3 + np.arange(3)).reshape(-1)


def fold_stem_pool_params_lite(det_vars: Dict[str, Any], pool: int, s2d: int = 4) -> Dict[str, Any]:
    """Expand conv1's (3, 3, s2d²·3, Cout) kernel of a flax-layout variable
    tree to (3, 3, (s2d·pool)²·3, Cout) so ``LiteDetector(stem_pool=pool)``
    on pool·canvas frames reproduces pool-then-detect exactly: each fine
    channel takes its coarse parent's weight divided by pool²."""
    if pool == 1:
        return det_vars
    params = dict(det_vars["params"])
    stem = dict(params["conv1"])
    conv = dict(stem["Conv_0"])
    conv["kernel"] = np.asarray(conv["kernel"])[:, :, _fine_to_coarse(pool, s2d), :] / (pool * pool)
    stem["Conv_0"] = conv
    params["conv1"] = stem
    out = dict(det_vars)
    out["params"] = params
    return out


class LiteDetector(nn.Module):
    """Space-to-depth ultra-light multi-level face detector.

    ``forward(images)`` with images (B, H, W, 3) normalized ((x−127.5)/128),
    H and W multiples of 32·stem_pool, returns the ``ScrfdDetector`` output
    dict, float32.
    """

    def __init__(self, widths: Sequence[int] = (64, 128, 192, 256), fpn_width: int = 64,
                 head_depth: int = 2, dtype: torch.dtype = torch.float32, stem_pool: int = 1,
                 s2d: int = 4):
        super().__init__()
        self.dtype = dtype
        self.stem_pool = stem_pool
        self.s2d = s2d
        # Not a buffer: the flax tree has no such leaf and loads strictly.
        self._fold_src = torch.from_numpy(_fine_to_coarse(stem_pool, s2d))
        self.conv1 = _ConvBN(s2d * s2d * 3, widths[0], 3, 1)
        self.conv2 = _ConvBN(widths[0], widths[0], 3, 1)
        cin = widths[0]
        for i, w in enumerate(widths[1:], start=1):
            self.add_module(f"down{i}", _ConvBN(cin, w, 3, 2))
            self.add_module(f"conv{i + 2}", _ConvBN(w, w, 3, 1))
            cin = w
        c3, c4, c5 = widths[1:]
        self.lat5 = Conv(c5, fpn_width, 1, bias=True)
        self.lat4 = Conv(c4, fpn_width, 1, bias=True)
        self.lat3 = Conv(c3, fpn_width, 1, bias=True)
        for i in range(3):
            self.add_module(f"smooth{i}", _ConvBN(fpn_width, fpn_width, 3, 1))
        self.head = _ScrfdHead(fpn_width, fpn_width, head_depth)
        self.n_stages = len(widths) - 1

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        p = self.stem_pool
        if p == 1:
            return self.conv1(x)
        weight = self.conv1.Conv_0.weight
        if self._fold_src.device != weight.device:
            self._fold_src = self._fold_src.to(weight.device)
        w = weight[:, self._fold_src] / (p * p)  # fold_stem_pool_params_lite
        return F.relu(self.conv1.BatchNorm_0(F.conv2d(x, w.to(x.dtype), None, 1, 1)))

    def forward(self, images: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        x = space_to_depth(images.to(self.dtype), self.s2d * self.stem_pool).permute(0, 3, 1, 2)
        x = self.conv2(self._stem(x))
        feats = []
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"conv{i + 2}")(getattr(self, f"down{i}")(x))
            feats.append(x)  # strides 8, 16, 32
        c3, c4, c5 = feats

        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _upsample2(p5)
        p3 = self.lat3(c3) + _upsample2(p4)
        levels = [getattr(self, f"smooth{i}")(p) for i, p in enumerate((p3, p4, p5))]
        return {stride: self.head(feat) for stride, feat in zip(STRIDES, levels)}


__all__ = ["LiteDetector", "fold_stem_pool_params_lite", "space_to_depth"]
