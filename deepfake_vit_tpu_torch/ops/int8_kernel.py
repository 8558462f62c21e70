"""The two int8 products of the serving path: the s8×s8→s32 GEMM of the
int8 EfficientNet tail and the s8 convolution of the int8 SCRFD detector,
hand-written in CUDA C++ for Hopper (``csrc/int8.cu``).

Both compute ``(f32(acc)·sx)·sw + bias`` with an exact s32 sum ``acc``,
per-output-channel weight scales ``sw`` and activation scales ``sx`` that
are one value for the whole tensor (static, calibrated) or one per image
(dynamic). On the TPU these were XLA ops (``dot_general`` and
``conv_general_dilated`` with ``preferred_element_type=int32``), not Pallas
kernels; stock PyTorch has no CUDA int8 convolution and ``torch._int_mm`` is
a library call, so each has a kernel of the port's own.

The GEMM runs on the tensor cores (``mma.sync`` s8 tiles, a tile per
shape from :func:`int8_gemm_plan`); the convolution on the integer pipes.
Each wrapper checks its inputs, allocates the output with ``torch.empty``
and launches its kernel on the current stream for CUDA tensors; for CPU
tensors it runs the plain PyTorch version beside it. The plain versions sum
in float64, which is exact here (|acc| ≤ 9·256·127² < 2⁵³; float32 would
not be: K·127² exceeds 2²⁴ from K = 1041), so kernel and plain version agree
bit for bit. ``launches`` on each wrapper counts kernel launches and
nothing else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.layers import same_pads
from .cuda_build import SM_COUNT, SMEM_PER_BLOCK, check, library, stream


def _dequant(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(f32(acc)·sx)·sw + bias, in that order; acc (S, rows, N) exact integers."""
    y = acc.float() * sx[:, None, None] * sw
    return y if bias is None else y + bias


def _check_scales(name: str, dev, M: int, N: int, sx, sw, bias) -> int:
    """Validate the epilogue's operands; returns the rows that share one sx."""
    for label, t, n in (("sw", sw, N), ("bias", bias, N)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (n,) or t.device != dev:
            raise ValueError(f"{name}: {label} must be ({n},) float32 on {dev}")
    if sx.dtype != torch.float32 or sx.dim() != 1 or sx.device != dev:
        raise ValueError(f"{name}: sx must be a 1-D float32 tensor on {dev}")
    if sx.numel() == 0 or M % sx.numel():
        raise ValueError(f"{name}: {sx.numel()} scales do not divide {M} rows")
    return M // sx.numel()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Contiguous and 16-byte aligned (the kernels load whole words)."""
    if t is None:
        return None
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def int8_gemm_plain(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the GEMM kernel (float64 sum, exact)."""
    M, N = xq.shape[0], wq.shape[1]
    acc = xq.double() @ wq.double()
    return _dequant(acc.reshape(sx.numel(), -1, N), sx, sw, bias).reshape(M, N)


# The block tiles of the GEMM kernel, (rows, columns), in the order of
# csrc/int8.cu::kConfigs: 64 × 32 warp tiles, 64-byte K steps in a
# three-stage pipeline of 80-byte shared-memory rows.
GEMM_TILES = ((128, 128), (128, 64))


class GemmPlan(NamedTuple):
    """Launch plan of the GEMM kernel (``int8_gemm_mma_kernel``)."""

    config: int       # index into GEMM_TILES
    tile_m: int
    tile_n: int
    copy_bytes: int   # bytes per cp.async copy: 16, 8 or 4, the largest dividing K
    k_padded: int     # K rounded up to the 64-byte K step: the last step reads zeros
    smem_bytes: int
    blocks: int


def int8_gemm_plan(M: int, K: int, N: int) -> GemmPlan:
    """Block tile of the GEMM kernel for one shape: 128 × 128 where those
    tiles make at least two blocks for each of the H100's 132 SMs, so that
    the last wave's idle SMs cost little; otherwise 128 × 64, twice the
    blocks. At (4608, 2688, 448), for one, 128 × 128 tiles make 144 blocks,
    two on 12 SMs and one on the rest; 128 × 64 tiles make 252, two on
    nearly every SM."""
    config = 0 if -(-M // 128) * -(-N // 128) >= 2 * SM_COUNT else 1
    bm, bn = GEMM_TILES[config]
    smem = 3 * (bm + bn) * 80
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"int8_gemm: a {bm} x {bn} tile needs {smem} bytes of shared memory")
    copy = next(b for b in (16, 8, 4) if K % b == 0)
    return GemmPlan(config, bm, bn, copy, -(-K // 64) * 64, smem, -(-M // bm) * -(-N // bn))


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(f32(xq @ wq)·sx)·sw + bias`` with an exact s32 product.

    xq: (M, K) s8; wq: (K, N) s8; sw, bias: (N,) f32; sx: (S,) f32 with S
    dividing M — consecutive groups of M/S rows share one activation scale
    (S = 1: one static scale; S = images: per-image dynamic scales).
    K and N must be multiples of 4. Returns (M, N) f32.

    The kernel reads the weights K-major. A ``wq`` stored so — the (K, N)
    transpose view of a contiguous (N, K) tensor, as ``Int8TailRunner``
    keeps its weights — goes to it as it is; any other ``wq`` is copied
    K-major first, and that copy is work of the call.
    """
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_gemm: shapes {tuple(xq.shape)} x {tuple(wq.shape)} do not multiply")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 operands, got {xq.dtype} and {wq.dtype}")
    (M, K), N = xq.shape, wq.shape[1]
    if K % 4 or N % 4:
        raise ValueError(f"int8_gemm: K = {K} and N = {N} must be multiples of 4")
    dev = xq.device
    if wq.device != dev:
        raise ValueError("int8_gemm: wq must lie on xq's device")
    rows_per_scale = _check_scales("int8_gemm", dev, M, N, sx, sw, bias)
    if dev.type == "cpu":
        return int8_gemm_plain(xq, wq, sx, sw, bias)
    if dev.type != "cuda":
        raise RuntimeError(f"int8_gemm has no kernel for device {dev}")
    if N > 65535 * 64:
        raise ValueError(f"int8_gemm: N = {N} is more column tiles than a grid holds")
    plan = int8_gemm_plan(M, K, N)
    xq, wt, sx, sw, bias = (_aligned(t) for t in (xq, wq.t(), sx, sw, bias))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = library().dfv_int8_gemm(xq.data_ptr(), wt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                                  _ptr(bias), out.data_ptr(), M, K, N, rows_per_scale,
                                  plan.config, plan.copy_bytes, stream())
    check(err, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------


def _conv_geometry(xq: torch.Tensor, kq: torch.Tensor, stride: int):
    """XLA 'SAME' geometry: ((top, bottom), (left, right)) pads and (Ho, Wo)."""
    _, H, W, _ = xq.shape
    k = kq.shape[0]
    return (same_pads(H, k, stride), same_pads(W, k, stride)), (-(-H // stride), -(-W // stride))


def int8_conv_plain(xq: torch.Tensor, kq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the convolution kernel: one float64 matrix
    product per kernel tap on the shifted, strided view of the zero-padded
    image, summed (exact)."""
    B, _, _, Cin = xq.shape
    k, Cout = kq.shape[0], kq.shape[3]
    ((pt, pb), (pl, pr)), (Ho, Wo) = _conv_geometry(xq, kq, stride)
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb)).double()
    kd = kq.double()
    acc = torch.zeros((B, Ho, Wo, Cout), dtype=torch.float64, device=xq.device)
    for r in range(k):
        for s in range(k):
            view = xp[:, r:r + (Ho - 1) * stride + 1:stride, s:s + (Wo - 1) * stride + 1:stride]
            acc += view @ kd[r, s]
    return _dequant(acc.reshape(sx.numel(), -1, Cout), sx, sw, bias).reshape(B, Ho, Wo, Cout)


def int8_conv(xq: torch.Tensor, kq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1) -> torch.Tensor:
    """s8 convolution with XLA 'SAME' padding, dequantized to f32.

    xq: (B, H, W, Cin) s8 NHWC; kq: (k, k, Cin, Cout) s8 HWIO; sw, bias:
    (Cout,) f32; sx: (1,) or (B,) f32 (one static scale, or one per image).
    'SAME' padding is asymmetric at stride 2 on even sizes (k3 pads (0, 1),
    k1 nothing). Cin and Cout must be multiples of 4. Returns
    (B, ⌈H/stride⌉, ⌈W/stride⌉, Cout) f32 = ``(f32(acc)·sx)·sw + bias``.
    """
    if xq.dim() != 4 or kq.dim() != 4 or kq.shape[0] != kq.shape[1] or xq.shape[3] != kq.shape[2]:
        raise ValueError(f"int8_conv: image {tuple(xq.shape)} (NHWC) and kernel "
                         f"{tuple(kq.shape)} (square HWIO) do not match")
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 operands, got {xq.dtype} and {kq.dtype}")
    B, H, W, Cin = xq.shape
    k, Cout = kq.shape[0], kq.shape[3]
    if Cin % 4 or Cout % 4:
        raise ValueError(f"int8_conv: Cin = {Cin} and Cout = {Cout} must be multiples of 4")
    if stride < 1:
        raise ValueError("int8_conv: stride must be positive")
    dev = xq.device
    if kq.device != dev:
        raise ValueError("int8_conv: kq must lie on xq's device")
    ((pt, _), (pl, _)), (Ho, Wo) = _conv_geometry(xq, kq, stride)
    rows_per_scale = _check_scales("int8_conv", dev, B * Ho * Wo, Cout, sx, sw, bias)
    if sx.numel() not in (1, B):
        raise ValueError(f"int8_conv: sx must hold 1 or {B} scales, got {sx.numel()}")
    if dev.type == "cpu":
        return int8_conv_plain(xq, kq, sx, sw, bias, stride)
    if dev.type != "cuda":
        raise RuntimeError(f"int8_conv has no kernel for device {dev}")
    xq, kq, sx, sw, bias = (_aligned(t) for t in (xq, kq, sx, sw, bias))
    out = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=dev)
    err = library().dfv_int8_conv(xq.data_ptr(), kq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                                  _ptr(bias), out.data_ptr(), B, H, W, Cin, Cout, k, stride,
                                  pt, pl, Ho, Wo, rows_per_scale, stream())
    check(err, "int8_conv")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


__all__ = ["GEMM_TILES", "GemmPlan", "int8_conv", "int8_conv_plain", "int8_gemm", "int8_gemm_plain",
           "int8_gemm_plan"]
