"""The single-block fused MBConv prototype (stride 1, 3×3), hand-written in
CUDA C++ for Hopper (``csrc/fused.cu``, entry ``dfv_fused_mbconv``).

Counterpart of ``deepfake_vit_tpu/ops/pallas/fused_mbconv.py``: the first
design of the fused block, which no pipeline path uses. It shares its device
code with the fused-stage block (``ops/fused_stages.py``) and differs in two
rounding points: the expanded activations stay in float32 into the depthwise
conv, and the squeeze-excite mean is taken from the bf16-rounded depthwise
output. NHWC in and out, as the JAX function.

:func:`fused_mbconv` launches the kernels for CUDA tensors and runs
:func:`fused_mbconv_plain` for CPU tensors; ``fused_mbconv.launches`` counts
kernel launches (one group of three device launches per call) and nothing
else.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..models.quant import fold_bn, folded_hwio
from .fused_stages import BlockPlan, check_block, launch_block, mbconv_plain

_ORDER = ("w_exp", "b_exp", "w_dw", "b_dw", "w_se1", "b_se1", "w_se2", "b_se2", "w_proj", "b_proj")


def fold_mbconv_params(block, expand_ratio: int) -> Dict[str, torch.Tensor]:
    """Fold an ``MBConvBlock`` module's BatchNorms into float32 weights, with
    the JAX function's names and layouts: w_exp (Cexp, Cin), b_exp (Cexp),
    w_dw (3, 3, Cexp), b_dw, w_se1 (Cse, Cexp), b_se1, w_se2 (Cexp, Cse),
    b_se2, w_proj (Cout, Cexp), b_proj. Without an expand conv w_exp is the
    identity and b_exp zero."""
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        if expand_ratio != 1:
            k, b = folded_hwio(block.expand_conv, block.bn0)
            out["w_exp"], out["b_exp"] = k[0, 0].t(), b
        else:
            cin = block.depthwise_conv.weight.shape[0]
            dev = block.depthwise_conv.weight.device
            out["w_exp"] = torch.eye(cin, device=dev)
            out["b_exp"] = torch.zeros(cin, device=dev)
        kdw, bdw = folded_hwio(block.depthwise_conv, block.bn1)
        out["w_dw"], out["b_dw"] = kdw[:, :, 0, :], bdw
        out["w_se1"] = block.se_reduce.weight[:, :, 0, 0].float()
        out["b_se1"] = block.se_reduce.bias.float()
        out["w_se2"] = block.se_expand.weight[:, :, 0, 0].float()
        out["b_se2"] = block.se_expand.bias.float()
        kp, bp = folded_hwio(block.project_conv, block.bn2)
        out["w_proj"], out["b_proj"] = kp[0, 0].t(), bp
        return {k: v.detach().clone().contiguous() for k, v in out.items()}


def _plan_and_weights(x: torch.Tensor, folded: Dict[str, torch.Tensor], expand_ratio: int):
    """The kernel's view of ``folded``: products' weights rounded to bf16,
    the rest float32, taps flattened to (9, Cexp)."""
    missing = [k for k in _ORDER if k not in folded]
    if missing:
        raise ValueError(f"fused_mbconv: folded weights lack {missing}")
    if x.dim() != 4:
        raise ValueError(f"fused_mbconv: x must be (B, H, W, Cin) NHWC, got {tuple(x.shape)}")
    if folded["w_dw"].dim() != 3 or tuple(folded["w_dw"].shape[:2]) != (3, 3):
        raise ValueError("fused_mbconv: w_dw must be (3, 3, Cexp): the prototype is 3×3 only")
    cin, cexp = x.shape[3], folded["w_dw"].shape[2]
    cout, cse = folded["w_proj"].shape[0], folded["w_se1"].shape[0]
    bp = BlockPlan(kernel=3, stride=1, cin=cin, cexp=cexp, cse=cse, cout=cout,
                   has_expand=expand_ratio != 1, residual=cin == cout)
    f32 = {k: folded[k].float() for k in _ORDER}
    weights = [f32["w_exp"].to(torch.bfloat16), f32["b_exp"], f32["w_dw"].reshape(9, cexp),
               f32["b_dw"], f32["w_se1"], f32["b_se1"], f32["w_se2"], f32["b_se2"],
               f32["w_proj"].to(torch.bfloat16), f32["b_proj"]]
    return bp, weights


def fused_mbconv_plain(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                       expand_ratio: int) -> torch.Tensor:
    """Plain PyTorch version of the prototype kernel (see
    ``ops/fused_stages.py::mbconv_plain`` with ``proto=True``)."""
    bp, weights = _plan_and_weights(x, folded, expand_ratio)
    return mbconv_plain(bp, x.to(torch.bfloat16), weights, proto=True)


def fused_mbconv(x: torch.Tensor, folded: Dict[str, torch.Tensor],
                 expand_ratio: int) -> torch.Tensor:
    """One stride-1 3×3 MBConv block, BatchNorm folded, fused on the chip.

    x: (B, H, W, Cin) bf16 or f32 NHWC (rounded to bf16 on entry, as the JAX
    function does); ``folded``: the weights of :func:`fold_mbconv_params`.
    The residual is added when Cin == Cout. Returns (B, H, W, Cout) bf16.
    """
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_mbconv takes bf16 or f32 activations, got {x.dtype}")
    bp, weights = _plan_and_weights(x, folded, expand_ratio)
    x = x.to(torch.bfloat16)
    check_block("fused_mbconv", bp, x, weights)
    if x.device.type == "cpu":
        return mbconv_plain(bp, x, weights, proto=True)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mbconv has no kernel for device {x.device}")
    out = launch_block("dfv_fused_mbconv", bp, x, weights,
                       (int(bp.has_expand), int(bp.residual)))
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0

__all__ = ["fold_bn", "fold_mbconv_params", "fused_mbconv", "fused_mbconv_plain"]
