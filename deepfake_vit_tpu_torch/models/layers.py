"""Flax-compatible building blocks: Conv, Dense and BatchNorm.

Parameters are kept in float32 (flax's ``param_dtype``) and cast to the
activation dtype at use, as flax's ``dtype`` does; BatchNorm normalizes in
float32 and returns the input dtype. Convolutions run NCHW. Each layer
loads its flax subtree (``load_flax``) and initializes itself the way the
flax default initializers do (``reset_parameters`` with a
``torch.Generator``), so the bridge and the seeded init stay mechanical.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


def _as_tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _copy_checked(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} does not match {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.device, dst.dtype))


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: variance 1/fan_in, normal truncated at ±2σ."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    with torch.no_grad():
        w.copy_((z.clamp(-2.0, 2.0) * std).to(w.dtype))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA/TF 'SAME' padding (lo, hi) for one spatial axis: asymmetric
    (extra row at the end) when the total is odd, e.g. k3-s2 on even sizes."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW tensors. ``weight`` is OIHW (flax HWIO
    kernels are transposed on load); ``padding`` is "SAME" or explicit
    ((top, bottom), (left, right))."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME", groups: int = 1, bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.padding, self.groups = kernel, stride, padding, groups
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """(top, bottom, left, right) for an (h, w) input."""
        if self.padding == "SAME":
            return (*same_pads(h, self.kernel, self.stride), *same_pads(w, self.kernel, self.stride))
        (t, b), (l, r) = self.padding
        return t, b, l, r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        t, b, l, r = self.pads(x.shape[-2], x.shape[-1])
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (l, r, t, b))
            pad = 0
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, bias, self.stride, pad, 1, self.groups)

    def load_flax(self, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        k = _as_tensor(params["kernel"])  # (kh, kw, cin/groups, cout)
        _copy_checked(self.weight, k.permute(3, 2, 0, 1), "Conv.kernel")
        if self.bias is not None:
            _copy_checked(self.bias, _as_tensor(params["bias"]), "Conv.bias")
        elif "bias" in params:
            raise ValueError("flax Conv has a bias but this Conv does not")

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Dense(nn.Module):
    """flax ``nn.Dense``; ``weight`` is (out, in), flax kernels are (in, out)."""

    def __init__(self, in_features: int, features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)

    def load_flax(self, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        _copy_checked(self.weight, _as_tensor(params["kernel"]).t(), "Dense.kernel")
        if self.bias is not None:
            _copy_checked(self.bias, _as_tensor(params["bias"]), "Dense.bias")
        elif "bias" in params:
            raise ValueError("flax Dense has a bias but this Dense does not")

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 (NCHW or (B, C)) with running stats,
    computed in float32 and returned in the input dtype."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def load_flax(self, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        _copy_checked(self.weight, _as_tensor(params["scale"]), "BatchNorm.scale")
        _copy_checked(self.bias, _as_tensor(params["bias"]), "BatchNorm.bias")
        _copy_checked(self.running_mean, _as_tensor(stats["mean"]), "BatchNorm.mean")
        _copy_checked(self.running_var, _as_tensor(stats["var"]), "BatchNorm.var")

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded flax-default init of every layer, in module registration order."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(g)
    return module
