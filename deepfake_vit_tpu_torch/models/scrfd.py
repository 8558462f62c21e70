"""SCRFD-style face detector: residual backbone (C3/C4/C5) → FPN neck →
shared per-level head emitting, at strides {8, 16, 32} with 2 anchors per
location, objectness scores (A), distance-to-sides boxes (4A) and 5-point
landmark offsets (10A).

Submodules are named after the flax tree keys (``_ConvBN_0``,
``_ResBlock_3/BatchNorm_1``, ``lat5``, ``smooth0``, ``head/tower0``,
``cls``) so ``models/bridge.py`` maps weights mechanically. Public
input/output layout is NHWC like the JAX package; convolutions run NCHW.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import NUM_ANCHORS, STRIDES
from .layers import BatchNorm, Conv

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9  # flax's, for the running statistics in train mode


def _fold_kernel(k, pool: int):
    """(kh, kw, cin, cout) kernel → (p·kh, p·kw, cin, cout) with each tap
    spread over its p×p block and divided by p²; numpy or torch."""
    if isinstance(k, torch.Tensor):
        return k.repeat_interleave(pool, 0).repeat_interleave(pool, 1) / (pool * pool)
    k = np.asarray(k)
    return np.repeat(np.repeat(k, pool, axis=0), pool, axis=1) / (pool * pool)


def fold_stem_pool_params(det_vars: Dict[str, Any], pool: int) -> Dict[str, Any]:
    """Expand the first stem conv's kernel so a conv at stride p·s
    reproduces avg-pool(p)-then-conv exactly: w'[p·i+a, p·j+b] = w[i, j]/p²
    for a, b < p. Pure function of a flax-layout variable tree."""
    if pool == 1:
        return det_vars
    params = dict(det_vars["params"])
    stem = dict(params["_ConvBN_0"])
    conv = dict(stem["Conv_0"])
    conv["kernel"] = _fold_kernel(conv["kernel"], pool)
    stem["Conv_0"] = conv
    params["_ConvBN_0"] = stem
    out = dict(det_vars)
    out["params"] = params
    return out


class _ConvBN(nn.Module):
    """Conv (no bias) → BatchNorm → ReLU.

    ``fold_pool=p > 1``: the conv absorbs a preceding p× average pool —
    kernel p·k, stride p·s, explicit (0, p) padding (TF-SAME of the pooled
    k3-s2 conv maps to (0, p) zeros at the original resolution). The module
    keeps the UNFOLDED k×k weight, the flax tree's own, and expands it at
    use (``fold_stem_pool_params``' arithmetic).
    """

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 fold_pool: int = 1):
        super().__init__()
        self.fold_pool = fold_pool
        self.Conv_0 = Conv(cin, features, kernel, stride)
        self.BatchNorm_0 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.fold_pool
        if p > 1:
            w = _fold_kernel(self.Conv_0.weight.permute(2, 3, 1, 0), p).permute(3, 2, 0, 1)
            x = F.conv2d(F.pad(x, (0, p, 0, p)), w.to(x.dtype), None, self.Conv_0.stride * p)
        else:
            x = self.Conv_0(x)
        return F.relu(self.BatchNorm_0(x))


class _ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self._ConvBN_0 = _ConvBN(cin, features, 3, stride)
        self.Conv_0 = Conv(features, features, 3)
        self.BatchNorm_0 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_1 = Conv(cin, features, 1, stride)
            self.BatchNorm_1 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(self.Conv_0(self._ConvBN_0(x)))
        residual = self.BatchNorm_1(self.Conv_1(x)) if self.project else x
        return F.relu(y + residual)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2× nearest upsample, NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class _ScrfdHead(nn.Module):
    def __init__(self, cin: int, width: int, depth: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"tower{i}", _ConvBN(cin if i == 0 else width, width, 3, 1))
        c = width if depth else cin
        self.cls = Conv(c, NUM_ANCHORS, 3, bias=True)
        self.box = Conv(c, 4 * NUM_ANCHORS, 3, bias=True)
        self.kps = Conv(c, 10 * NUM_ANCHORS, 3, bias=True)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = x.shape[0]
        for i in range(self.depth):
            x = getattr(self, f"tower{i}")(x)

        wide = torch.promote_types(x.dtype, torch.float32)  # float64 stays

        def flat(y: torch.Tensor, k: int) -> torch.Tensor:
            # NHWC row-major, then anchor — permute before the reshape.
            return y.permute(0, 2, 3, 1).reshape(B, -1, k).to(wide)

        return {
            "scores": flat(self.cls(x), 1)[..., 0],
            "bbox": flat(self.box(x), 4),
            "kps": flat(self.kps(x), 10),
        }


class ScrfdDetector(nn.Module):
    """Multi-level face detection network.

    ``forward(images)`` with images (B, H, W, 3) normalized ((x−127.5)/128)
    returns {stride: {'scores': (B, N_l), 'bbox': (B, N_l, 4),
    'kps': (B, N_l, 10)}}, float32, N_l = (H/s)(W/s)·A flattened row-major
    then anchor. ``stem_pool=p > 1`` takes p·input_size frames and gives the
    outputs of pool-then-detect (the stem conv folds the pool).
    """

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 blocks_per_stage: Sequence[int] = (2, 2, 2, 2), fpn_width: int = 64,
                 head_width: int = 64, head_depth: int = 2, dtype: torch.dtype = torch.float32,
                 stem_pool: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stem_pool = stem_pool
        self._ConvBN_0 = _ConvBN(3, widths[0], 3, 2, fold_pool=stem_pool)
        self._ConvBN_1 = _ConvBN(widths[0], widths[0], 3, 2)
        idx, cin = 0, widths[0]
        self.stage_ends = []
        for w, n in zip(widths[1:], blocks_per_stage[1:]):
            for k in range(n):
                self.add_module(f"_ResBlock_{idx}", _ResBlock(cin, w, stride=2 if k == 0 else 1))
                idx, cin = idx + 1, w
            self.stage_ends.append(idx - 1)
        c3, c4, c5 = widths[1:]
        self.lat5 = Conv(c5, fpn_width, 1, bias=True)
        self.lat4 = Conv(c4, fpn_width, 1, bias=True)
        self.lat3 = Conv(c3, fpn_width, 1, bias=True)
        for i in range(3):
            self.add_module(f"smooth{i}", _ConvBN(fpn_width, fpn_width, 3, 1))
        self.head = _ScrfdHead(fpn_width, head_width, head_depth)

    def forward(self, images: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self._ConvBN_1(self._ConvBN_0(x))
        feats = []
        for i in range(self.stage_ends[-1] + 1):
            x = getattr(self, f"_ResBlock_{i}")(x)
            if i in self.stage_ends:
                feats.append(x)  # strides 8, 16, 32
        c3, c4, c5 = feats

        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _upsample2(p5)
        p3 = self.lat3(c3) + _upsample2(p4)
        levels = [getattr(self, f"smooth{i}")(p) for i, p in enumerate((p3, p4, p5))]
        return {stride: self.head(feat) for stride, feat in zip(STRIDES, levels)}
