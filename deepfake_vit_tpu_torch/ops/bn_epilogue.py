"""The EfficientNet backbone's BatchNorm epilogues in one bf16 channels-last
pass each, hand-written in CUDA C++ for Hopper (``csrc/epilogue.cu``, entry
``dfv_epilogue``).

They replace no Pallas kernel: XLA fused these passes in the JAX package.
Eager PyTorch runs an inference BatchNorm (``models/layers.py::BatchNorm``)
as about nine float32 broadcast passes over the channels-last conv output,
then SiLU, the squeeze-excite gate or the residual add as passes of their
own. Each kernel here reads the bf16 conv output once and writes the
block's next bf16 tensor once, with the eager path's rounding points, bit
for bit:

- :func:`bn_act`: ``silu(bn(x))`` (the stem, ``bn0``, ``bn1``, the head);
- :func:`bn_add`: ``bn(x)``, plus a residual when one is given (``bn2``);
- :func:`se_gate`: ``x · gate[b, c]``, the gate already through the sigmoid.

A BatchNorm enters as its (3, C) float32 ``factors`` (:func:`bn_factors`):
running mean, ``mul = rsqrt(var + eps) · weight`` by the eager BatchNorm's
own torch expression, bias. Each wrapper takes bf16 4-D channels-last
tensors whose C is a multiple of 8, allocates its output with
``torch.empty_like`` and launches on the current stream without a sync (so
it may be captured in a CUDA graph); for CPU tensors it runs the plain
PyTorch version beside it. ``launches`` on each wrapper counts kernel
launches and nothing else.

The backbone calls :func:`silu_bn`, :func:`bn_residual` and
:func:`se_scale`: they take the kernels where :func:`engages` holds, and run
the eager expression unchanged anywhere else (the train step, float32
pipelines, the CPU).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import SM_COUNT, check, library, stream

# csrc/epilogue.cu: threads a block, and blocks the grid keeps resident on
# each SM (__launch_bounds__(256, 3)): one wave of a grid-stride loop.
EPILOGUE_THREADS = 256
EPILOGUE_BLOCKS_PER_SM = 3
_BN_SILU, _BN, _BN_RESIDUAL, _SE_GATE = range(4)


class EpiloguePlan(NamedTuple):
    """Launch plan of one epilogue kernel over a (B, C, H, W) tensor."""

    nvec: int    # 16-byte vectors: numel / 8
    cv: int      # vectors a pixel: C / 8
    hwcv: int    # vectors an image: H · W · cv
    lanes: int   # pixels in flight: the grid runs lanes · cv threads
    blocks: int


@functools.lru_cache(maxsize=256)
def epilogue_plan(shape: Tuple[int, int, int, int]) -> EpiloguePlan:
    """A grid of whole pixel rows: ``lanes`` pixels of C / 8 threads, as
    many lanes as fill one wave of resident blocks (at most every pixel),
    so that every thread keeps its 8 channels through its grid-stride loop."""
    B, C, H, W = shape
    cv = C // 8
    npix = B * H * W
    lanes = max(1, min(npix, SM_COUNT * EPILOGUE_BLOCKS_PER_SM * EPILOGUE_THREADS // cv))
    return EpiloguePlan(npix * cv, cv, H * W * cv, lanes, -(-lanes * cv // EPILOGUE_THREADS))


# ---------------------------------------------------------------------------
# BatchNorm factors
# ---------------------------------------------------------------------------


def _factor_key(bn):
    """The four tensors' storage and version counters, and eps; None for
    inference tensors, which have no version counter."""
    m, v, w, b = bn.running_mean, bn.running_var, bn.weight, bn.bias
    try:
        return (m.data_ptr(), m._version, v.data_ptr(), v._version, w.data_ptr(), w._version,
                b.data_ptr(), b._version, bn.eps)
    except RuntimeError:
        return None


def bn_factors(bn) -> torch.Tensor:
    """(3, C) float32: the BatchNorm's running mean, ``mul = rsqrt(var +
    eps) · weight`` (the eager BatchNorm's expression, in the parameters'
    dtype) and bias.

    Cached on the module, keyed on the four tensors' storage and version
    counters, so a load, an optimizer step or a move recomputes it. Under
    CUDA graph capture a miss is not cached: the captured computation has
    not run yet."""
    key = _factor_key(bn)
    cached = bn.__dict__.get("_epilogue_factors")
    if key is not None and cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        factors = torch.stack([bn.running_mean.float(), mul.float(), bn.bias.float()])
    if key is not None and not (factors.is_cuda and torch.cuda.is_current_stream_capturing()):
        bn._epilogue_factors = (key, factors)
    return factors


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _bn_plain(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """The eager BatchNorm's arithmetic: ``((f32(x) − mean) · mul) + bias``,
    returned in x's dtype."""
    mean, mul, bias = (f.view(1, -1, 1, 1) for f in factors)
    return ((x.float() - mean) * mul + bias).to(x.dtype)


def bn_act_plain(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``bn_act_kernel``: ``silu(bn(x))``."""
    return F.silu(_bn_plain(x, factors))


def bn_add_plain(x: torch.Tensor, factors: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``bn_add_kernel``: ``bn(x)`` (+ residual)."""
    y = _bn_plain(x, factors)
    return y if residual is None else y + residual


def se_gate_plain(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``se_gate_kernel``: ``x · gate[b, c]``."""
    return x * gate[:, :, None, None]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _channels_last_bf16(name: str, label: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bf16 activations, got {label} {t.dtype}")
    if t.dim() != 4 or t.shape[1] % 8 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: {label} must be a channels-last (B, C, H, W) tensor with C a "
                         f"multiple of 8, got {tuple(t.shape)} strides {t.stride()}")


def _check(name: str, x: torch.Tensor, others) -> None:
    """x bf16 channels-last; each of ``others`` (label, tensor, shape,
    dtype) on x's device, of that shape and dtype, and dense: a 4-D one
    channels-last, any other contiguous."""
    _channels_last_bf16(name, "x", x)
    for label, t, shape, dtype in others:
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be {shape} {dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if t.dim() == 4:
            _channels_last_bf16(name, label, t)
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.device.type != "cpu" and x.device.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for device {x.device}")


def _launch(kernel, mode: int, x: torch.Tensor, other: Optional[torch.Tensor],
            factors: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch ``kernel``'s device code on operands already checked and
    count the launch on the wrapper."""
    name = kernel.__name__
    if any(t is not None and t.data_ptr() % 16 for t in (x, other, factors)):
        raise ValueError(f"{name}: every operand must be 16-byte aligned")
    if x.numel() // 8 >= 2 ** 31:
        raise ValueError(f"{name}: {x.numel()} elements are more vectors than the kernel indexes")
    out = torch.empty_like(x)
    plan = epilogue_plan(tuple(x.shape))
    if plan.nvec == 0:
        return out
    err = library().dfv_epilogue(x.data_ptr(), None if other is None else other.data_ptr(),
                                 out.data_ptr(), None if factors is None else factors.data_ptr(),
                                 mode, plan.nvec, plan.cv, plan.hwcv, plan.lanes, plan.blocks,
                                 stream())
    check(err, name)
    kernel.launches += 1
    return out


def bn_act(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """``silu(bn(x))`` in one pass. x: (B, C, H, W) bf16 channels-last;
    factors: (3, C) float32 contiguous (:func:`bn_factors`)."""
    C = x.shape[1] if x.dim() == 4 else -1
    _check("bn_act", x, [("factors", factors, (3, C), torch.float32)])
    if x.device.type == "cpu":
        return bn_act_plain(x, factors)
    return _launch(bn_act, _BN_SILU, x, None, factors)


def bn_add(x: torch.Tensor, factors: torch.Tensor,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn(x)``, plus ``residual`` (x's shape, bf16 channels-last) when one
    is given, in one pass."""
    C = x.shape[1] if x.dim() == 4 else -1
    others = [("factors", factors, (3, C), torch.float32)]
    if residual is not None:
        others.append(("residual", residual, tuple(x.shape), torch.bfloat16))
    _check("bn_add", x, others)
    if x.device.type == "cpu":
        return bn_add_plain(x, factors, residual)
    return _launch(bn_add, _BN if residual is None else _BN_RESIDUAL, x, residual, factors)


def se_gate(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``x · gate[b, c]`` in one pass. gate: (B, C) bf16 contiguous, already
    through the sigmoid."""
    shape = tuple(x.shape[:2]) if x.dim() == 4 else (-1, -1)
    _check("se_gate", x, [("gate", gate, shape, torch.bfloat16)])
    if x.device.type == "cpu":
        return se_gate_plain(x, gate)
    return _launch(se_gate, _SE_GATE, x, gate, None)


bn_act.launches = 0
bn_add.launches = 0
se_gate.launches = 0


# ---------------------------------------------------------------------------
# The backbone's entry points
# ---------------------------------------------------------------------------


def _on_kernel_device(t: torch.Tensor) -> bool:
    return t.is_cuda


def _kernel_operand(t: torch.Tensor) -> bool:
    return (_on_kernel_device(t) and t.dtype == torch.bfloat16 and t.dim() == 4
            and t.shape[1] % 8 == 0 and t.is_contiguous(memory_format=torch.channels_last)
            and t.data_ptr() % 16 == 0)


def engages(x: torch.Tensor, bn, residual: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernels take the epilogue of BatchNorm ``bn``: x (and
    the residual) on CUDA, bf16, 4-D, channels-last-contiguous with C a
    multiple of 8 (every EfficientNet width is) and 16-byte aligned; the
    BatchNorm on CUDA and on its running statistics (eval, or ``frozen``);
    no autograd recorded. The backbone's entry points then launch the
    kernels straight away: these checks are the wrappers'."""
    if torch.is_grad_enabled() and not torch.is_inference_mode_enabled():
        return False
    if (bn.training and not bn.frozen) or not _on_kernel_device(bn.running_mean):
        return False
    return _kernel_operand(x) and (residual is None or (residual.shape == x.shape
                                                       and _kernel_operand(residual)))


def silu_bn(x: torch.Tensor, bn) -> torch.Tensor:
    """``F.silu(bn(x))``: one :func:`bn_act` pass where :func:`engages`."""
    if engages(x, bn):
        return _launch(bn_act, _BN_SILU, x, None, bn_factors(bn))
    return F.silu(bn(x))


def bn_residual(x: torch.Tensor, bn, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn(x)`` (``+ residual``): one :func:`bn_add` pass where
    :func:`engages`."""
    if engages(x, bn, residual):
        return _launch(bn_add, _BN if residual is None else _BN_RESIDUAL, x, residual,
                       bn_factors(bn))
    y = bn(x)
    return y if residual is None else y + residual


def se_scale(x: torch.Tensor, se: torch.Tensor, bn) -> torch.Tensor:
    """``x · sigmoid(se)`` for the squeeze-excite logits se (B, C, 1, 1) of
    x, the output of BatchNorm ``bn`` and its SiLU: one :func:`se_gate`
    pass where :func:`engages` holds for that BatchNorm."""
    gate = torch.sigmoid(se)
    if engages(x, bn) and gate.dtype == torch.bfloat16 and gate.shape == (*x.shape[:2], 1, 1):
        return _launch(se_gate, _SE_GATE, x, gate.reshape(x.shape[:2]).contiguous(), None)
    return x * gate
