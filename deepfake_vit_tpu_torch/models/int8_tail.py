"""Int8 late-stage backbone tail (inference serving path).

The late EfficientNet blocks' 1×1 convolutions — expand and project, where
the operations are — run as s8×s8→s32 products through the hand-written
GEMM kernel (``ops/int8_kernel.py::int8_gemm``), with per-output-channel
weight scales and either calibrated static or dynamic per-image activation
scales. Depthwise convs, squeeze-excitation and the head conv stay bf16.
BatchNorm is folded into the conv weights when the runner is built, and the
quantized weights are kept K-major, as the GEMM kernel reads them.

Counterpart of ``deepfake_vit_tpu/models/int8_tail.py`` with the same
rounding points: bf16 after each SiLU, f32 bias add, f32 residual add
before the cast to bf16. The runner works on NHWC tensors so that the GEMM
sees (B·H·W, C) rows without a permute per block.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from ..ops.int8_kernel import int8_gemm
from .efficientnet import _B0_STAGES, VARIANT_PARAMS, EfficientNetBackbone, round_repeats
from .layers import same_pads
from .quant import (dynamic_scale, folded_hwio, merge_max, quant_w, quantize_s8, scale_tensor,
                    static_scale)
from .s2d_early import S2DEarlyRunner


def default_tail_start(variant: str) -> int:
    """First block of stage 4 (the second 14² stage) — blocks 16-31 for b4."""
    _, depth, _, _ = VARIANT_PARAMS[variant]
    return sum(round_repeats(r, depth) for r, *_ in _B0_STAGES[:4])


def _gemm_weights(w: torch.Tensor):
    """Quantized (Cin, Cout) weights for ``int8_gemm``: (wq, sw) with wq
    stored K-major, the (Cin, Cout) view of a contiguous (Cout, Cin)
    tensor, which the kernel reads without a copy."""
    wq, sw = quant_w(w)
    return wq.t().contiguous().t(), sw


def _int8_matmul(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                 sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, Cin) × (Cin, Cout) through the s8 GEMM; f32 output.

    ``sx=None`` → dynamic per-image scales (a max-abs reduction per call);
    a (1,) tensor is a calibrated static scale."""
    xf = x.float()
    if sx is None:
        sx = dynamic_scale(xf)
    xq = quantize_s8(xf, sx)
    y = int8_gemm(xq.reshape(-1, xq.shape[-1]), wq, sx, sw, bias)
    return y.reshape(*x.shape[:-1], wq.shape[1])


class Int8TailRunner:
    """Callable: block-``start`` input activations → final block output maps.

    Built once from a backbone's parameters: BatchNorms are folded and the
    weights quantized here, not per call. Build it again after the
    backbone's weights change. Finish the network with
    ``backbone(maps, start_block=len(backbone.blocks))`` so that the head
    conv, attention and classifier run unquantized.

    ``act_scales``: per-tail-block ``{'exp': s, 'proj': s}`` static
    activation scales from :func:`calibrate_act_scales` (None → dynamic
    per-image scales).
    """

    def __init__(self, backbone: EfficientNetBackbone, start_block: Optional[int] = None,
                 act_scales: Optional[List[Dict[str, float]]] = None):
        self.variant = backbone.variant
        self.act_scales = act_scales
        self.start = default_tail_start(self.variant) if start_block is None else start_block
        self.n_blocks = len(backbone.blocks)
        device = backbone.head_conv.weight.device
        if act_scales is not None and len(act_scales) != self.n_blocks - self.start:
            raise ValueError(f"act_scales has {len(act_scales)} entries for "
                             f"{self.n_blocks - self.start} tail blocks")
        self._sx = [{k: scale_tensor(v, device) for k, v in s.items()}
                    for s in act_scales or [{}] * (self.n_blocks - self.start)]
        self.blocks: List[Dict[str, Any]] = []
        for i in range(self.start, self.n_blocks):
            blk = getattr(backbone, f"block_{i}")
            entry: Dict[str, Any] = {"args": backbone.blocks[i]}
            if blk.expand_ratio != 1:
                k, b = folded_hwio(blk.expand_conv, blk.bn0)
                entry["exp"] = (*_gemm_weights(k[0, 0]), b)
            kdw, bdw = folded_hwio(blk.depthwise_conv, blk.bn1)
            entry["dw"] = (kdw.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(), bdw)
            with torch.no_grad():
                entry["se"] = (
                    blk.se_reduce.weight[:, :, 0, 0].t().to(torch.bfloat16).float().contiguous(),
                    blk.se_reduce.bias.detach().float(),
                    blk.se_expand.weight[:, :, 0, 0].t().to(torch.bfloat16).float().contiguous(),
                    blk.se_expand.bias.detach().float(),
                )
            k, b = folded_hwio(blk.project_conv, blk.bn2)
            entry["proj"] = (*_gemm_weights(k[0, 0]), b)
            self.blocks.append(entry)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) bf16 input activations of flat block ``start``."""
        return self._run(x)

    def calibrate(self, x: torch.Tensor):
        """Run the tail recording the max-abs activation at every quantize
        point. Returns (output, records); records mirrors ``act_scales``
        with 0-d tensors."""
        records: List[Dict[str, torch.Tensor]] = []
        return self._run(x, records), records

    @torch.inference_mode()
    def _run(self, x: torch.Tensor, records: Optional[list] = None) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        for e, sx in zip(self.blocks, self._sx):
            a = e["args"]
            rec: Dict[str, torch.Tensor] = {}
            if records is not None:
                records.append(rec)
            inputs = x
            if "exp" in e:
                if records is not None:
                    rec["exp"] = x.float().abs().max()
                x = F.silu(_int8_matmul(x, *e["exp"], sx=sx.get("exp"))).to(torch.bfloat16)
            kdw, bdw = e["dw"]
            xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor
            (t, b), (l, r) = (same_pads(n, a["kernel"], a["stride"]) for n in xc.shape[2:])
            y = F.conv2d(F.pad(xc, (l, r, t, b)), kdw, None, a["stride"], 0, 1, kdw.shape[0])
            x = F.silu(y.permute(0, 2, 3, 1).float() + bdw).to(torch.bfloat16)
            w1, b1, w2, b2 = e["se"]
            se = x.mean(dim=(1, 2), keepdim=True)
            se = F.silu(se.float() @ w1 + b1).to(torch.bfloat16)
            se = se.float() @ w2 + b2
            x = x * torch.sigmoid(se).to(torch.bfloat16)
            if records is not None:
                rec["proj"] = x.float().abs().max()
            y = _int8_matmul(x, *e["proj"], sx=sx.get("proj"))
            if a["stride"] == 1 and a["in_filters"] == a["out_filters"]:
                y = y + inputs.float()
            x = y.to(torch.bfloat16)
        return x


def calibrate_act_scales(backbone: EfficientNetBackbone, face_batches: Iterable[torch.Tensor],
                         start_block: Optional[int] = None, margin: float = 1.0,
                         early: Optional[S2DEarlyRunner] = None) -> List[Dict[str, float]]:
    """Post-training calibration of static activation scales.

    ``face_batches``: pre-normalized model inputs (B, H, W, 3), the tensors
    the backbone sees in serving. Runs the early blocks in bf16 and the tail
    once per batch, recording the max-abs at every quantize point; returns
    per-tail-block {'exp', 'proj'} scales (max over batches / 127 · margin)
    for ``Int8TailRunner(act_scales=…)``. ``early``: the s2d stages, which
    stand in for the stock blocks before their ``resume_block``, as in
    serving.
    """
    start = default_tail_start(backbone.variant) if start_block is None else start_block
    if start < 1:
        raise ValueError("calibration requires start_block >= 1")
    runner = Int8TailRunner(backbone, start_block=start)
    maxes: Optional[List[Dict[str, float]]] = None
    for faces in face_batches:
        with torch.inference_mode():
            x, resume = (faces, 0) if early is None else (early(faces), early.resume_block)
            split = backbone(x, start_block=resume, stop_block=start, dtype=torch.bfloat16)
        _, records = runner.calibrate(split.permute(0, 2, 3, 1))
        maxes = [merge_max(m, r) for m, r in zip(maxes or [None] * len(records), records)]
    if maxes is None:
        raise ValueError("no calibration batches provided")
    return [{k: static_scale(v, margin) for k, v in m.items()} for m in maxes]


__all__ = ["Int8TailRunner", "calibrate_act_scales", "default_tail_start"]
