"""Plain PyTorch layers shared by the reference networks.

Everything here computes in float32 (TF32 is switched off by the caller,
``float32_exact``). ``Operands`` rounds the inputs and the outputs of every
convolution, linear layer and matrix product: the identity in float32, and
e4m3 fp8 with a per-tensor scale for the control, the reference computed one
precision below the configuration's bf16 (whose activations are stored in
bf16 between the layers, as the control's are in fp8).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite e4m3 value


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 fp8 under one scale for the whole tensor (its
    largest magnitude maps to 448); the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


class Operands:
    """Rounding of the operands of every product: ``"fp32"`` (none) or
    ``"fp8"``."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown operand precision {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mode == "fp32" else fp8_round(t)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow 'SAME' padding of one axis: the odd pixel goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


Padding = Union[str, Sequence[int]]


def conv(x: torch.Tensor, w: torch.Tensor, P: Operands, stride: int = 1,
         padding: Padding = "SAME", groups: int = 1,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NCHW convolution with an OIHW kernel; ``padding`` "SAME" or explicit
    (top, bottom, left, right)."""
    k = w.shape[-1]
    if padding == "SAME":
        t, b = same_pads(x.shape[2], k, stride)
        l, r = same_pads(x.shape[3], k, stride)
    else:
        t, b, l, r = padding
    x = F.pad(x, (l, r, t, b))
    return P(F.conv2d(P(x), P(w), bias, stride, 0, 1, groups))


def linear(x: torch.Tensor, w: torch.Tensor, P: Operands,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ wᵀ + bias, w as (out, in)."""
    return P(F.linear(P(x), P(w), bias))


def batch_norm(x: torch.Tensor, sd: dict, prefix: str, eps: float,
               batch_stats: bool = False) -> torch.Tensor:
    """Batch normalization over dim 1 by the running statistics, or with
    ``batch_stats`` by the batch's mean and biased variance, which then
    become the running statistics (in ``sd``)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if batch_stats:
        dims = (0,) + tuple(range(2, x.dim()))
        mean, var = x.mean(dims), x.var(dims, unbiased=False)
        sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = mean.detach(), var.detach()
    else:
        mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    inv = torch.rsqrt(var + eps) * sd[f"{prefix}.weight"]
    return (x - mean.view(shape)) * inv.view(shape) + sd[f"{prefix}.bias"].view(shape)


def layer_norm(x: torch.Tensor, sd: dict, prefix: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], eps)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pool of NHWC images."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
