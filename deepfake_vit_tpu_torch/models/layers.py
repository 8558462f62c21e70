"""Flax-compatible building blocks: Conv, Dense, BatchNorm, LayerNorm,
MultiHeadDotProductAttention, Dropout and drop-connect.

Parameters are kept in float32 (flax's ``param_dtype``) and cast to the
activation dtype at use, as flax's ``dtype`` does; BatchNorm normalizes in
float32 and returns the input dtype. Convolutions run NCHW. Each layer
loads its flax subtree (``load_flax``), writes it back (``export_flax``)
and initializes itself the way the flax default initializers do
(``reset_parameters`` with a ``torch.Generator``), so the bridge and the
seeded init stay mechanical. A layer whose flax subtree holds nodes
rather than arrays names its keys in ``FLAX_KEYS`` (the attention's
``query``/``key``/``value``/``out``).

Train mode follows flax's ``train=True``: BatchNorm normalizes with the
batch's statistics and moves its running ones, Dropout and drop-connect
draw their masks from the ``torch.Generator`` they are given (the default
generator when None). ``module.eval()`` makes all three deterministic.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


def _as_tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


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

    def export_flax(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        params = {"kernel": _numpy(self.weight.permute(2, 3, 1, 0))}
        if self.bias is not None:
            params["bias"] = _numpy(self.bias)
        return params, {}

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

    def export_flax(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        params = {"kernel": _numpy(self.weight.t())}
        if self.bias is not None:
            params["bias"] = _numpy(self.bias)
        return params, {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 (NCHW or (B, C)), computed in
    float32 (float64 for float64 inputs) and returned in the input dtype.

    In eval mode, or when ``frozen`` (the backbone's ``freeze_bn``), it
    normalizes with the running statistics. In train mode it normalizes
    with the batch's mean and biased variance over every dim but 1
    (flax's E[x²] − E[x]², clipped at 0) and, unless
    ``update_stats`` is off, moves the running statistics to
    ``m · running + (1 − m) · batch`` with flax's ``momentum`` m and the
    biased variance (unlike ``torch.nn.BatchNorm2d``, whose momentum is
    1 − m and whose running variance is unbiased).
    """

    def __init__(self, features: int, eps: float, momentum: float = 0.99, frozen: bool = False):
        super().__init__()
        self.eps, self.momentum, self.frozen = eps, momentum, frozen
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training and not self.frozen:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def load_flax(self, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        _copy_checked(self.weight, _as_tensor(params["scale"]), "BatchNorm.scale")
        _copy_checked(self.bias, _as_tensor(params["bias"]), "BatchNorm.bias")
        _copy_checked(self.running_mean, _as_tensor(stats["mean"]), "BatchNorm.mean")
        _copy_checked(self.running_var, _as_tensor(stats["var"]), "BatchNorm.var")

    def export_flax(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return ({"scale": _numpy(self.weight), "bias": _numpy(self.bias)},
                {"mean": _numpy(self.running_mean), "var": _numpy(self.running_var)})

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last dim: the statistics in float32
    (float64 for float64 inputs) as flax's ``_compute_stats`` takes them
    (mean and E[x²] − E[x]², clipped at 0), ``(x − mean) · (rsqrt(var +
    eps) · scale) + bias`` in that precision, returned in the input dtype."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)

    def load_flax(self, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        _copy_checked(self.weight, _as_tensor(params["scale"]), "LayerNorm.scale")
        _copy_checked(self.bias, _as_tensor(params["bias"]), "LayerNorm.bias")

    def export_flax(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return {"scale": _numpy(self.weight), "bias": _numpy(self.bias)}, {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` self-attention on (B, L, W),
    as flax 0.12's ``dot_product_attention_weights`` computes it: the query
    divided by √hd before QKᵀ, the softmax's result in the activation
    dtype (``force_fp32_for_softmax=False``; ``torch.softmax`` rounds once
    where XLA also rounds the exponentials and their sum), one dropout mask
    of shape (L, L) broadcast over batch and heads (``broadcast_dropout``),
    the weights times V, then the output projection.

    The query, key and value projections are one (3W, W) GEMM: flax's
    ``query``/``key``/``value`` kernels (W, H, hd) and biases (H, hd) are
    stacked on load and split again on export; ``out``'s kernel is
    (H, hd, W)."""

    FLAX_KEYS = frozenset({"query", "key", "value", "out"})

    def __init__(self, width: int, heads: int, dropout_rate: float = 0.0):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of {heads} heads")
        self.width, self.heads, self.dropout_rate = width, heads, dropout_rate
        self.qkv_weight = nn.Parameter(torch.empty(3 * width, width))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_weight = nn.Parameter(torch.empty(width, width))
        self.out_bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L, W = x.shape
        H, dt = self.heads, x.dtype
        hd = W // H
        qkv = F.linear(x, self.qkv_weight.to(dt), self.qkv_bias.to(dt))
        q, k, v = qkv.view(B, L, 3, H, hd).permute(2, 0, 3, 1, 4)  # each (B, H, L, hd)
        q = q / torch.tensor(math.sqrt(hd), dtype=dt, device=x.device)
        weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)  # (B, H, L, L)
        if self.training and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            mask = keep_mask((L, L), keep, x, generator).to(dt)
            weights = weights * (mask / torch.tensor(keep, dtype=dt, device=x.device))
        o = (weights @ v).transpose(1, 2).reshape(B, L, W)
        return F.linear(o, self.out_weight.to(dt), self.out_bias.to(dt))

    def load_flax(self, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
        W = self.width
        kernels = [_as_tensor(params[n]["kernel"]) for n in ("query", "key", "value")]
        for n, k in zip(("query", "key", "value"), kernels):
            if tuple(k.shape) != (W, self.heads, W // self.heads):
                raise ValueError(f"attention {n}.kernel: shape {tuple(k.shape)} does not match "
                                 f"{(W, self.heads, W // self.heads)}")
        _copy_checked(self.qkv_weight, torch.cat([k.reshape(W, W).t() for k in kernels]),
                      "attention qkv kernel")
        _copy_checked(self.qkv_bias, torch.cat([_as_tensor(params[n]["bias"]).reshape(W)
                                                for n in ("query", "key", "value")]),
                      "attention qkv bias")
        out = _as_tensor(params["out"]["kernel"])
        if tuple(out.shape) != (self.heads, W // self.heads, W):
            raise ValueError(f"attention out.kernel: shape {tuple(out.shape)} does not match "
                             f"{(self.heads, W // self.heads, W)}")
        _copy_checked(self.out_weight, out.reshape(W, W).t(), "attention out kernel")
        _copy_checked(self.out_bias, _as_tensor(params["out"]["bias"]), "attention out bias")

    def export_flax(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        W, H = self.width, self.heads
        params = {}
        for i, n in enumerate(("query", "key", "value")):
            rows = slice(i * W, (i + 1) * W)
            params[n] = {"kernel": _numpy(self.qkv_weight[rows].t()).reshape(W, H, W // H),
                         "bias": _numpy(self.qkv_bias[rows]).reshape(H, W // H)}
        params["out"] = {"kernel": _numpy(self.out_weight.t()).reshape(H, W // H, W),
                         "bias": _numpy(self.out_bias)}
        return params, {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's DenseGeneral draws each kernel on its flattened (W, W)
        # shape: lecun-normal with fan-in W.
        lecun_normal_(self.qkv_weight, self.width, generator)
        lecun_normal_(self.out_weight, self.width, generator)
        nn.init.zeros_(self.qkv_bias)
        nn.init.zeros_(self.out_bias)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """Within the block no BatchNorm of ``module`` moves its running
    statistics (a forward that is run again, as activation checkpointing
    does in the backward, must not count its batch twice)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


def keep_mask(shape: Sequence[int], keep: float, like: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bernoulli(keep) draws of ``shape`` on ``like``'s device, as bool."""
    return torch.rand(tuple(shape), generator=generator, device=like.device) < keep


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 − rate and
    scaled by 1/(1 − rate), else 0 (all 0 at rate 1)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    return torch.where(keep_mask(x.shape, keep, x, generator), x / keep, torch.zeros_like(x))


def drop_connect(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth on a residual branch, per sample: ``x / keep · mask``
    with one Bernoulli(keep) draw a sample, in x's dtype."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, x, generator).to(x.dtype)
    return x / keep * mask


class Dropout(nn.Module):
    """:func:`dropout` in train mode, the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, generator) if self.training else x


def ensure_eval(*modules: nn.Module) -> None:
    """Put each network back in eval mode if it was left in train mode
    (``module.train()``): serving objects call this before they run their
    networks, which must normalize with the running statistics and drop
    nothing. Reads only the root's flag, so a call costs nothing when the
    network is in eval mode already."""
    for m in modules:
        if m.training:
            m.eval()


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded flax-default init of every layer, in module registration order."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(g)
    return module
