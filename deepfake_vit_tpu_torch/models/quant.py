"""Quantization arithmetic shared by the int8 tail and the int8 detector.

Everything here is float32 with the JAX package's operation order, so that
the quantized weights come out equal to the JAX runners': a one-ulp
difference in a folded kernel flips an s8 weight by one step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .layers import BatchNorm, Conv


def fold_bn(kernel: torch.Tensor, bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm into a conv kernel with output channels
    last: ``scale = γ/√(var + eps)``, ``bias = β − mean·scale``; returns
    (kernel·scale, bias).

    The square root is taken in float64 and rounded to float32, which gives
    the correctly rounded float32 root (as XLA's and numpy's are);
    ``torch.sqrt`` on float32 CPU tensors may be one ulp off."""
    root = torch.sqrt((bn.running_var + bn.eps).double()).float()
    scale = bn.weight / root
    bias = bn.bias - bn.running_mean * scale
    return kernel * scale, bias


def hwio(conv: Conv) -> torch.Tensor:
    """The conv's weight in the flax layout (kh, kw, cin/groups, cout), float32."""
    return conv.weight.detach().float().permute(2, 3, 1, 0)


def folded_hwio(conv: Conv, bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm folded into the conv: (HWIO kernel, bias), float32."""
    with torch.no_grad():
        k, b = fold_bn(hwio(conv), bn)
    return k.contiguous(), b.float().contiguous()


def quant_w(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a kernel with
    output channels last ((Cin, Cout) matrix or HWIO): (wq s8, sw f32)."""
    s = (w.abs().amax(dim=tuple(range(w.dim() - 1))) / 127.0).clamp_min(1e-8)
    wq = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return wq.contiguous(), s.float().contiguous()


def dynamic_scale(xf: torch.Tensor) -> torch.Tensor:
    """Per-image activation scale max|x|/127 (≥ 1e-8) of a float32
    (B, ...) tensor; returns (B,)."""
    return (xf.abs().amax(dim=tuple(range(1, xf.dim()))) / 127.0).clamp_min(1e-8)


def quantize_s8(xf: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """clip(round(x/sx), −127, 127) as s8: a true division and
    round-half-to-even. ``sx`` holds 1 scale or one per image."""
    s = sx.reshape(-1, *([1] * (xf.dim() - 1)))
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8)


def static_scale(max_abs: float, margin: float = 1.0) -> float:
    """Calibrated scale from a recorded max-abs: computed in double, as the
    JAX package's Python floats are; it rounds to float32 once, on use."""
    return max(max_abs / 127.0 * margin, 1e-8)


def scale_tensor(scale: float, device) -> torch.Tensor:
    return torch.tensor([scale], dtype=torch.float32, device=device)


def merge_max(maxes: Optional[Dict[str, float]], records: Dict[str, torch.Tensor]):
    """Running max of recorded max-abs values over calibration batches."""
    vals = {k: float(v) for k, v in records.items()}
    if maxes is None:
        return vals
    return {k: max(maxes[k], v) for k, v in vals.items()}


__all__ = ["fold_bn", "hwio", "folded_hwio", "quant_w", "dynamic_scale", "quantize_s8",
           "static_scale", "scale_tensor", "merge_max"]
