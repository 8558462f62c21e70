"""EfficientNet backbone (Tan & Le, 2019), flax-tree compatible.

Same variants, rounding rules and block arguments as the JAX package;
convolutions use XLA/TF 'SAME' padding (asymmetric at stride 2), BatchNorm
eps 1e-3. Submodules carry the flax names (``stem_conv``, ``block_7/
expand_conv``, ``bn0``…``bn2``, ``head_conv``). Inference only: dropout and
stochastic depth are identities.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv, drop_connect, dropout

# Base (B0) stages: (num_repeat, kernel, stride, expand_ratio, in, out, se_ratio)
_B0_STAGES = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)

# variant -> (width_mult, depth_mult, resolution, dropout)
VARIANT_PARAMS = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

_BN_MOMENTUM = 0.99
_BN_EPS = 1e-3


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    """Round channel counts to the nearest multiple of ``divisor``."""
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def block_args(variant: str) -> Tuple[Dict[str, Any], ...]:
    """Flattened per-block arguments for a variant (stride only on block 0)."""
    width, depth, _, _ = VARIANT_PARAMS[variant]
    blocks = []
    for repeat, kernel, stride, expand, fin, fout, se in _B0_STAGES:
        fin_r = round_filters(fin, width)
        fout_r = round_filters(fout, width)
        for i in range(round_repeats(repeat, depth)):
            blocks.append(dict(
                kernel=kernel,
                stride=stride if i == 0 else 1,
                expand_ratio=expand,
                in_filters=fin_r if i == 0 else fout_r,
                out_filters=fout_r,
                se_ratio=se,
            ))
    return tuple(blocks)


def feature_dim(variant: str) -> int:
    """Head channel count (1792 for b4)."""
    return round_filters(1280, VARIANT_PARAMS[variant][0])


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation, NCHW."""

    def __init__(self, kernel: int, stride: int, expand_ratio: int, in_filters: int,
                 out_filters: int, se_ratio: float, drop_rate: float = 0.0,
                 freeze_bn: bool = False):
        super().__init__()
        self.expand_ratio, self.se_ratio, self.drop_rate = expand_ratio, se_ratio, drop_rate
        self.residual = stride == 1 and in_filters == out_filters
        expanded = in_filters * expand_ratio
        bn = dict(eps=_BN_EPS, momentum=_BN_MOMENTUM, frozen=freeze_bn)
        if expand_ratio != 1:
            self.expand_conv = Conv(in_filters, expanded, 1)
            self.bn0 = BatchNorm(expanded, **bn)
        self.depthwise_conv = Conv(expanded, expanded, kernel, stride, groups=expanded)
        self.bn1 = BatchNorm(expanded, **bn)
        if se_ratio > 0:
            se_filters = max(1, int(in_filters * se_ratio))
            self.se_reduce = Conv(expanded, se_filters, 1, bias=True)
            self.se_expand = Conv(se_filters, expanded, 1, bias=True)
        self.project_conv = Conv(expanded, out_filters, 1)
        self.bn2 = BatchNorm(out_filters, **bn)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inputs = x
        if self.expand_ratio != 1:
            x = F.silu(self.bn0(self.expand_conv(x)))
        x = F.silu(self.bn1(self.depthwise_conv(x)))
        if self.se_ratio > 0:
            se = x.mean(dim=(2, 3), keepdim=True)
            se = self.se_expand(F.silu(self.se_reduce(se)))
            x = x * torch.sigmoid(se)
        x = self.bn2(self.project_conv(x))
        if self.residual:
            if self.training and self.drop_rate > 0:
                x = drop_connect(x, self.drop_rate, generator)
            x = x + inputs
        return x


class EfficientNetBackbone(nn.Module):
    """EfficientNet feature backbone.

    ``forward(x)`` takes (B, H, W, 3) normalized images (NHWC) and returns
    the final (B, C, h, w) feature map (NCHW), or with
    ``return_maps=False`` its mean over h, w through dropout
    (``dropout_rate``). ``start_block > 0`` resumes mid-network: x is then
    the NCHW input activation of flat block ``start_block``
    (``len(blocks)``: only the head conv runs). ``stop_block`` stops early
    and returns the NCHW input activation of flat block ``stop_block``.
    ``dtype`` overrides the module's activation dtype for this call;
    ``generator`` feeds the train-mode masks. Block ``idx`` drops its
    residual branch at ``drop_connect_rate · idx / len(blocks)`` (setting
    ``drop_connect_rate`` sets every block's rate).
    """

    def __init__(self, variant: str = "b4", dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.4, drop_connect_rate: float = 0.2,
                 freeze_bn: bool = False):
        super().__init__()
        self.variant, self.dtype, self.dropout_rate = variant, dtype, dropout_rate
        bn = dict(eps=_BN_EPS, momentum=_BN_MOMENTUM, frozen=freeze_bn)
        width = VARIANT_PARAMS[variant][0]
        stem = round_filters(32, width)
        self.stem_conv = Conv(3, stem, 3, 2)
        self.stem_bn = BatchNorm(stem, **bn)
        self.blocks = block_args(variant)
        for idx, args in enumerate(self.blocks):
            self.add_module(f"block_{idx}", MBConvBlock(**args, freeze_bn=freeze_bn))
        head = feature_dim(variant)
        self.head_conv = Conv(self.blocks[-1]["out_filters"], head, 1)
        self.head_bn = BatchNorm(head, **bn)
        self.drop_connect_rate = drop_connect_rate

    @property
    def drop_connect_rate(self) -> float:
        return self._drop_connect_rate

    @drop_connect_rate.setter
    def drop_connect_rate(self, rate: float) -> None:
        self._drop_connect_rate = rate
        for idx in range(len(self.blocks)):
            getattr(self, f"block_{idx}").drop_rate = rate * idx / len(self.blocks)

    @property
    def feature_dim(self) -> int:
        return feature_dim(self.variant)

    def forward(self, x: torch.Tensor, start_block: int = 0, stop_block: Optional[int] = None,
                dtype: Optional[torch.dtype] = None, generator: Optional[torch.Generator] = None,
                return_maps: bool = True) -> torch.Tensor:
        x = x.to(dtype or self.dtype)
        if start_block == 0:
            x = x.permute(0, 3, 1, 2)
            x = F.silu(self.stem_bn(self.stem_conv(x)))
        last = len(self.blocks) if stop_block is None else stop_block
        for idx in range(start_block, last):
            x = getattr(self, f"block_{idx}")(x, generator)
        if stop_block is not None:
            return x
        maps = F.silu(self.head_bn(self.head_conv(x)))
        if return_maps:
            return maps
        pooled = maps.mean(dim=(2, 3))
        return dropout(pooled, self.dropout_rate, generator) if self.training else pooled


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def param_group_labels(module: nn.Module) -> Dict[str, str]:
    """Parameter name → 'stem' / 'blocks' / 'head' for discriminative
    learning rates, from the name's first component as the JAX function
    reads a flax tree's top key: a backbone's ``stem_*`` and ``block_*``
    get their groups, everything else (every parameter of a
    ``DeepfakeDetectionModel``, whose top keys are ``feature_extractor``
    and the head) is 'head'."""
    def label(name: str) -> str:
        top = _top(name)
        if top.startswith("stem"):
            return "stem"
        if top.startswith("block_"):
            return "blocks"
        return "head"

    return {name: label(name) for name, _ in module.named_parameters()}


def frozen_stage_mask(module: nn.Module, freeze_stages: int, variant: str = "b4") -> Dict[str, bool]:
    """Parameter name → True where the parameter trains when the first
    ``freeze_stages`` EfficientNet stages are frozen (0 = none, 7 = every
    block); the stem freezes whenever any stage does. Read from the name's
    first component, as :func:`param_group_labels` does."""
    _, depth, _, _ = VARIANT_PARAMS[variant]
    stage_ends, total = [], 0
    for repeat, *_ in _B0_STAGES:
        total += round_repeats(repeat, depth)
        stage_ends.append(total)
    frozen_upto = stage_ends[freeze_stages - 1] if freeze_stages > 0 else 0

    def trainable(name: str) -> bool:
        top = _top(name)
        if top.startswith("stem"):
            return freeze_stages == 0
        if top.startswith("block_"):
            return int(top.split("_")[1]) >= frozen_upto
        return True

    return {name: trainable(name) for name, _ in module.named_parameters()}
