"""The transformers' attention core in inference, one hand-written kernel in
CUDA C++ for Hopper (``csrc/self_attention.cu``, entry ``dfv_self_attention``).

It replaces no Pallas kernel: XLA fused the attention in the JAX package.
Eager PyTorch runs flax's attention core (:func:`self_attention_plain`) as
a blocking copy of the scalar √hd, a strided division of q, two batched
products that first copy K and V contiguous, a softmax over bf16 scores and
a copy of O back to (B, L, W). The kernel reads q, k and v where the QKV
product left them, keeps the scores in float32 registers and writes O once,
in the layout the output projection takes; it rounds the softmax's weights
and the output to bf16 once each, where the eager path also rounds the
scores, so it lies nearer float32 attention than the eager path does.

:func:`self_attention` takes the bf16 QKV product (B, L, 3W), W = heads ·
``HEAD_DIM``, 1 ≤ L ≤ ``MAX_SEQ``, its rows contiguous and 16-byte aligned
in two strides (a slice of a wider tensor, or ``x[:, 0]`` of a (B, N, L, 3W)
one, takes no copy), and returns O as a contiguous (B, L, W) tensor,
launched on the current stream without a sync. For CPU tensors it runs the
plain version. ``launches`` on it counts kernel launches and nothing else.

``models/layers.py::MultiHeadDotProductAttention`` launches the kernel where
:func:`engages` holds and runs the plain version anywhere else (the train
step, dropout, float32 and float64 models, other head widths, an additive
bias such as Swin's relative position bias and shift masks, the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .cuda_build import check, library, stream

# csrc/self_attention.cu: the head width, the longest sequence, the warps of
# a short-plan block (one warp a tile of 16 / rows pairs) and the short
# plan's longest sequence.
HEAD_DIM = 64
MAX_SEQ = 256
SHORT_WARPS = 8
SHORT_SEQ = 16
LOG2E = 1.4426950408889634


class AttentionPlan(NamedTuple):
    """``plan`` 0 (short: ``size`` rows a pair in an m16 tile, 8 or 16, in
    ``blocks`` of ``SHORT_WARPS`` warps) or 1 (long: ``size`` 0, one block a
    pair)."""
    plan: int
    size: int
    blocks: int


def self_attention_plan(batch: int, heads: int, seq: int) -> AttentionPlan:
    """The kernel's launch for ``batch`` sequences of ``seq`` tokens and
    ``heads`` heads, chosen by the sequence's length: up to ``SHORT_SEQ``
    the short plan packs two sequences of at most 8 (or one of at most 16)
    into one warp's 16 rows; above, one block a (sequence, head) pair stages
    its K and V, zero rows up to the next 16."""
    pairs = batch * heads
    if not 1 <= seq <= MAX_SEQ:
        raise ValueError(f"self_attention: sequences of 1 to {MAX_SEQ}, got {seq}")
    if seq <= SHORT_SEQ:
        rows = 8 if seq <= 8 else 16
        tiles = -(-pairs // (16 // rows))
        return AttentionPlan(0, rows, max(1, -(-tiles // SHORT_WARPS)))
    return AttentionPlan(1, 0, pairs)


def self_attention_plain(qkv: torch.Tensor, heads: int,
                         dropout: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax's attention core, as flax 0.12's ``dot_product_attention``
    computes it, on the QKV product (B, L, 3W): the query divided by √hd
    before QKᵀ, ``bias`` added to the scores, the softmax's result in the
    activation dtype, ``dropout`` (an (L, L) mask already divided by the
    keep rate, broadcast over batch and heads) on the weights, the weights
    times V; returns (B, L, W).

    ``bias`` (G, 1 or heads, L, L), in the activation dtype, is broadcast
    over the heads and over the batch taken as B / G groups of G
    consecutive sequences: sequence b adds ``bias[b % G]`` (the windows of
    an image, each with its own mask, and the images of a batch)."""
    B, L, W3 = qkv.shape
    W, dt = W3 // 3, qkv.dtype
    hd = W // heads
    q, k, v = qkv.view(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4)  # each (B, H, L, hd)
    q = q / torch.tensor(math.sqrt(hd), dtype=dt, device=qkv.device)
    scores = q @ k.transpose(-1, -2)  # (B, H, L, L)
    if bias is not None:
        G = bias.shape[0]
        scores = (scores.view(B // G, G, heads, L, L) + bias).view(B, heads, L, L)
    weights = torch.softmax(scores, dim=-1)
    if dropout is not None:
        weights = weights * dropout
    return (weights @ v).transpose(1, 2).reshape(B, L, W)


def _strides(qkv: torch.Tensor):
    """(batch stride, row stride) of qkv's rows, 0 for a dim of size 1."""
    return tuple(st if n > 1 else 0 for n, st in zip(qkv.shape[:2], qkv.stride()[:2]))


def _kernel_layout(qkv: torch.Tensor, heads: int) -> bool:
    """qkv is (B, L, 3 · heads · HEAD_DIM) with 1 ≤ L ≤ MAX_SEQ, its rows
    contiguous at strides that keep each 16-byte aligned and that the
    kernel's 32-bit indices reach."""
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * heads * HEAD_DIM or not 1 <= qkv.shape[1] <= MAX_SEQ:
        return False
    if qkv.stride(-1) != 1 or qkv.shape[0] * heads >= 2 ** 31:
        return False
    return all(st % 8 == 0 and 0 <= st < 2 ** 31 for st in _strides(qkv))


def _check(qkv: torch.Tensor, heads: int) -> None:
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"self_attention takes the bf16 QKV product, got {qkv.dtype}")
    if not _kernel_layout(qkv, heads):
        raise ValueError(f"self_attention: qkv must be (B, L, 3 x {heads} heads x {HEAD_DIM}) "
                         f"with 1 <= L <= {MAX_SEQ}, its rows contiguous at strides that are "
                         f"multiples of 8, got {tuple(qkv.shape)} strides {qkv.stride()}")
    if qkv.device.type != "cpu" and qkv.device.type != "cuda":
        raise RuntimeError(f"self_attention has no kernel for device {qkv.device}")


def launch(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Launch the kernel on operands already checked and count the launch on
    :func:`self_attention`."""
    if qkv.data_ptr() % 16:
        raise ValueError("self_attention: qkv must be 16-byte aligned")
    B, L, W3 = qkv.shape
    out = torch.empty((B, L, W3 // 3), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    plan = self_attention_plan(B, heads, L)
    batch_stride, row_stride = _strides(qkv)
    err = library().dfv_self_attention(qkv.data_ptr(), out.data_ptr(), B, L, heads, batch_stride,
                                       row_stride, plan.plan, plan.size, plan.blocks,
                                       LOG2E / math.sqrt(HEAD_DIM), stream())
    check(err, "self_attention")
    self_attention.launches += 1
    return out


def self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q kᵀ / √hd) v of each sequence and head of the QKV product, as
    (B, L, W) (the plain version on the CPU)."""
    _check(qkv, heads)
    if qkv.device.type == "cpu":
        return self_attention_plain(qkv, heads)
    return launch(qkv, heads)


self_attention.launches = 0


def _on_kernel_device(t: torch.Tensor) -> bool:
    return t.is_cuda


def engages(qkv: torch.Tensor, module, bias: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes the attention core of ``module`` (a
    ``MultiHeadDotProductAttention``) on its QKV product: qkv on CUDA, bf16,
    16-byte aligned, in the kernel's layout (``HEAD_DIM`` values a head, 1 ≤
    L ≤ ``MAX_SEQ``); no additive ``bias`` (the kernel adds none); no
    autograd recorded; no dropout (not training, or rate 0). ``forward``
    then calls :func:`launch` straight away: these are the wrapper's
    checks."""
    if bias is not None:
        return False
    if torch.is_grad_enabled() and not torch.is_inference_mode_enabled():
        return False
    if module.training and module.dropout_rate > 0.0:
        return False
    if not _on_kernel_device(qkv) or qkv.dtype != torch.bfloat16 or qkv.data_ptr() % 16:
        return False
    return _kernel_layout(qkv, module.heads)
