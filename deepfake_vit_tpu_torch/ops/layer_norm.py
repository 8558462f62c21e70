"""The transformers' LayerNorm in inference, one bf16 pass, hand-written in
CUDA C++ for Hopper (``csrc/layer_norm.cu``, entry ``dfv_layer_norm``).

It replaces no Pallas kernel: XLA fused the LayerNorm's passes in the JAX
package. Eager PyTorch runs flax's LayerNorm (:func:`layer_norm_plain`) as
about ten passes over float32 copies of the rows; the kernel reads each
bf16 row once and writes it once, with the plain version's rounding points
but for the order of its float32 row sums: the two agree within one bf16
step of the value.

:func:`layer_norm` takes bf16 x whose rows (the last dim, W a multiple of 8
up to ``MAX_WIDTH``) are contiguous and lie in at most two strides (``x[:,
0]`` of a contiguous (C, L, W) tensor, or a transposed view of it, takes no
copy), and (W,) float32 weight and bias on x's device; the kernel writes a
contiguous tensor of x's shape, launched on the current stream without a
sync. For CPU tensors it runs the plain version. ``launches`` on it counts kernel launches and nothing else.

``models/layers.py::LayerNorm`` launches the kernel where :func:`engages`
holds and runs the plain version anywhere else (the train step, float32 and
float64 models, the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda_build import SM_COUNT, check, library, stream

# csrc/layer_norm.cu: warps (one a row) a block, blocks the grid keeps
# resident on each SM (__launch_bounds__(256, 2)), and the widest row (three
# 16-byte vectors a lane).
LN_WARPS = 8
LN_BLOCKS_PER_SM = 2
MAX_WIDTH = 768


def layer_norm_plan(rows: int) -> int:
    """Blocks of the grid: one warp a row, as many blocks as fill one wave of
    resident blocks (no more than the rows need); each warp then walks its
    rows at the grid's stride."""
    return max(1, min(-(-rows // LN_WARPS), SM_COUNT * LN_BLOCKS_PER_SM))


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last dim: the statistics in float32
    (float64 for float64 inputs) as flax's ``_compute_stats`` takes them
    (mean and E[x²] − E[x]², clipped at 0), ``(x − mean) · (rsqrt(var +
    eps) · scale) + bias`` in that precision, returned in the input dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((xf - mean) * mul + bias).to(x.dtype)


def _row_layout(x: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """x's rows as an outer × inner grid: (rows, inner, outer stride, inner
    stride), row r at element (r // inner) · outer stride + (r % inner) ·
    inner stride from x's start; None where a row is not contiguous or the
    leading dims take more than two strides. One stride spans a contiguous
    tensor and ``x[:, 0]``; two the TimeSformer's temporal rows of a single
    clip, (N, T) patches by frames, a view of its frame-major tokens."""
    if x.dim() == 0:
        return None
    W = x.shape[-1]
    if x.numel() == 0:
        return 0, 1, W, W
    if x.stride(-1) != 1:
        return None
    groups = []  # [size, stride] of the merged leading dims, innermost first
    for n, st in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if n == 1:
            continue
        if groups and st == groups[-1][0] * groups[-1][1]:
            groups[-1][0] *= n
        else:
            groups.append([n, st])
    if len(groups) > 2:
        return None
    inner, inner_stride = groups[0] if groups else (1, W)
    outer, outer_stride = groups[1] if len(groups) == 2 else (1, inner * inner_stride)
    return outer * inner, inner, outer_stride, inner_stride


def _kernel_layout(x: torch.Tensor) -> bool:
    """x's rows, W a multiple of 8 up to MAX_WIDTH, lie in at most two
    strides that keep every row 16-byte aligned."""
    W = x.shape[-1] if x.dim() else 0
    if W % 8 or not 0 < W <= MAX_WIDTH:
        return False
    layout = _row_layout(x)
    return layout is not None and layout[2] % 8 == 0 and layout[3] % 8 == 0


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"layer_norm takes bf16 activations, got {x.dtype}")
    if not _kernel_layout(x):
        raise ValueError(f"layer_norm: x must hold contiguous rows of a multiple of 8 up to "
                         f"{MAX_WIDTH} values in at most two strides, each a multiple of 8, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    W = x.shape[-1]
    for label, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (W,):
            raise ValueError(f"layer_norm: {label} must be ({W},) float32 on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if x.device.type != "cpu" and x.device.type != "cuda":
        raise RuntimeError(f"layer_norm has no kernel for device {x.device}")


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float) -> torch.Tensor:
    """Launch the kernel on operands already checked and count the launch on
    :func:`layer_norm`."""
    rows, inner, outer_stride, inner_stride = _row_layout(x)
    if any(t.data_ptr() % 16 for t in (x, weight, bias)):
        raise ValueError("layer_norm: x, weight and bias must be 16-byte aligned")
    if max(rows, outer_stride, inner_stride) >= 2 ** 31:
        raise ValueError(f"layer_norm: {rows} rows at strides {outer_stride}, {inner_stride} are "
                         f"more than the kernel indexes")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    err = library().dfv_layer_norm(x.data_ptr(), out.data_ptr(), weight.data_ptr(),
                                   bias.data_ptr(), rows, x.shape[-1], inner, outer_stride,
                                   inner_stride, layer_norm_plan(rows), eps, stream())
    check(err, "layer_norm")
    layer_norm.launches += 1
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax's LayerNorm of x's rows in one pass (the plain version on the CPU)."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    return launch(x, weight, bias, eps)


layer_norm.launches = 0


def _on_kernel_device(t: torch.Tensor) -> bool:
    return t.is_cuda


def engages(x: torch.Tensor, module) -> bool:
    """Whether the kernel takes LayerNorm ``module`` on x: x on CUDA, bf16,
    its rows contiguous, in at most two strides and 16-byte aligned, W a
    multiple of 8 up to ``MAX_WIDTH``; the module's weight and bias (W,) float32 on
    x's device and aligned; no autograd recorded. ``LayerNorm.forward``
    then calls :func:`launch` straight away: these are the wrapper's
    checks."""
    if torch.is_grad_enabled() and not torch.is_inference_mode_enabled():
        return False
    if not _on_kernel_device(x) or x.dtype != torch.bfloat16 or x.data_ptr() % 16:
        return False
    if not _kernel_layout(x):
        return False
    return not any(t.dtype != torch.float32 or t.device != x.device
                   or tuple(t.shape) != (x.shape[-1],) or t.data_ptr() % 16
                   for t in (module.weight, module.bias))
