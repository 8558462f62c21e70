"""Int8 SCRFD detector graph (inference serving path).

SCRFD spends its operations in 3×3 convolutions spread over the whole net
(residual stages at C = 64/128/256, FPN smoothing, head towers). This
module re-emits the detector forward with every wide conv as an s8
convolution through the hand-written kernel
(``ops/int8_kernel.py::int8_conv``, which reads the quantized kernels
K-major, as the runner keeps them): per-output-channel symmetric weight
scales and calibrated static per-tensor activation scales
(:func:`calibrate_det_act_scales`), or dynamic per-image scales when
uncalibrated.

Not quantized, as in ``deepfake_vit_tpu/models/scrfd_int8.py``: the stem's
first conv (Cin = 3; it keeps the folded-pool ingest exact), the 1×1 FPN
lateral convs and the cls/box/kps output convs (fused into one conv of
Cout 2 + 8 + 20). Quantize points carry the JAX names: ``stem2``,
``b{i}_in``, ``b{i}_mid``, ``smooth{l}``, ``tw{l}_{t}``. The runner works
on NHWC tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.anchors import NUM_ANCHORS, STRIDES
from ..ops.int8_kernel import int8_conv
from .layers import same_pads
from .quant import (dynamic_scale, fold_bn, folded_hwio, hwio, merge_max, quant_w, quantize_s8,
                    scale_tensor, static_scale)
from .scrfd import ScrfdDetector, _fold_kernel

QuantConv = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (kq HWIO s8, sw, bias)


def _k_major(kq: torch.Tensor) -> torch.Tensor:
    """The HWIO view of a contiguous (Cout, k, k, Cin) copy of ``kq``: the
    layout ``int8_conv`` reads without a copy."""
    return kq.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2× nearest upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _oihw(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return k.permute(3, 2, 0, 1).to(dtype).contiguous()


class ScrfdInt8Runner:
    """Callable: normalized detection canvas → per-level head outputs.

    Same output contract as ``ScrfdDetector.forward``: {stride: {'scores':
    (B, N_l), 'bbox': (B, N_l, 4), 'kps': (B, N_l, 10)}}, float32. Built
    once from a detector's parameters (BatchNorm folding and weight
    quantization happen here); build it again after the weights change. The
    detector's ``stem_pool`` carries over: the first conv folds the pool.

    ``act_scales``: {name: float} static activation scales from
    :func:`calibrate_det_act_scales`; None → dynamic per-image max-abs
    scales (an extra reduction per conv).
    """

    def __init__(self, detector: ScrfdDetector, act_scales: Optional[Dict[str, float]] = None,
                 dtype: Optional[torch.dtype] = None):
        self.stem_pool = int(detector.stem_pool)
        self.act_scales = act_scales
        self.dtype = dtype = dtype or detector.dtype
        device = detector.lat5.weight.device
        self._sx = {k: scale_tensor(v, device) for k, v in (act_scales or {}).items()}

        def quantized(conv, bn) -> QuantConv:
            k, b = folded_hwio(conv, bn)
            kq, sw = quant_w(k)
            return _k_major(kq), sw, b

        # Stem conv 1: unquantized, keeps the (possibly pool-folded) ingest exact.
        stem = detector._ConvBN_0
        with torch.no_grad():
            k, b = fold_bn(_fold_kernel(hwio(stem.Conv_0), self.stem_pool), stem.BatchNorm_0)
        self.stem1 = (_oihw(k, dtype), b.float())
        self.stem1_stride = stem.Conv_0.stride * self.stem_pool
        self.stem2 = quantized(detector._ConvBN_1.Conv_0, detector._ConvBN_1.BatchNorm_0)

        self.blocks: List[Dict[str, Any]] = []
        for i in range(detector.stage_ends[-1] + 1):
            rb = getattr(detector, f"_ResBlock_{i}")
            entry: Dict[str, Any] = {
                "stride": rb._ConvBN_0.Conv_0.stride,
                "c1": quantized(rb._ConvBN_0.Conv_0, rb._ConvBN_0.BatchNorm_0),
                "c2": quantized(rb.Conv_0, rb.BatchNorm_0),
                "last": i in detector.stage_ends,
            }
            if rb.project:
                entry["down"] = quantized(rb.Conv_1, rb.BatchNorm_1)
            self.blocks.append(entry)

        with torch.no_grad():
            self.lats = {
                lvl: (getattr(detector, f"lat{lvl}").weight.detach().to(dtype),
                      getattr(detector, f"lat{lvl}").bias.detach().float())
                for lvl in (3, 4, 5)
            }
            head = detector.head
            outs = [head.cls, head.box, head.kps]
            # One fused output conv: cls/box/kps read the same tower output,
            # so their kernels concatenate along Cout (2 + 8 + 20 = 30).
            self.head_out = (torch.cat([c.weight.detach() for c in outs], 0).to(dtype),
                             torch.cat([c.bias.detach() for c in outs]).float())
        self.smooth = [quantized(m.Conv_0, m.BatchNorm_0)
                       for m in (getattr(detector, f"smooth{i}") for i in range(3))]
        self.towers = [quantized(m.Conv_0, m.BatchNorm_0)
                       for m in (getattr(head, f"tower{i}") for i in range(head.depth))]

    # ------------------------------------------------------------------
    def _quant_x(self, x: torch.Tensor, name: str, records: Optional[Dict[str, torch.Tensor]]):
        xf = x.float()
        if records is not None:
            records[name] = xf.abs().max()
        sx = self._sx.get(name)
        if sx is None:
            sx = dynamic_scale(xf)
        return quantize_s8(xf, sx), sx

    def _int8_conv(self, x, w: QuantConv, stride: int, name: str, records, relu: bool = True):
        """Quantize → s8 conv → dequant (+bias); optional ReLU; cast back."""
        kq, sw, b = w
        xq, sx = self._quant_x(x, name, records)
        y = int8_conv(xq, kq, sx, sw, b, stride)
        return (F.relu(y) if relu else y).to(self.dtype)

    def _conv_float(self, x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, stride: int = 1,
                    pads=None) -> torch.Tensor:
        """Unquantized conv in the runner's dtype on an NHWC tensor; f32 + bias out."""
        xc = x.to(self.dtype).permute(0, 3, 1, 2)
        if pads is None:
            pads = tuple(same_pads(n, k.shape[2], stride) for n in xc.shape[2:])
        (t, bt), (l, r) = pads
        y = F.conv2d(F.pad(xc, (l, r, t, bt)), k, None, stride)
        return y.permute(0, 2, 3, 1).float() + b

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def __call__(self, images: torch.Tensor,
                 records: Optional[Dict[str, torch.Tensor]] = None):
        """images: (B, H·p, W·p, 3), already (x−127.5)/128-normalized."""
        sp = self.stem_pool
        pads = None if sp == 1 else ((0, sp), (0, sp))
        x = F.relu(self._conv_float(images, *self.stem1, self.stem1_stride, pads)).to(self.dtype)
        x = self._int8_conv(x, self.stem2, 2, "stem2", records)

        feats = []
        for i, e in enumerate(self.blocks):
            # conv 1 and the downsample shortcut share the block input: one
            # quantize pass serves both convs.
            kq1, sw1, b1 = e["c1"]
            xq, sx = self._quant_x(x, f"b{i}_in", records)
            y = F.relu(int8_conv(xq, kq1, sx, sw1, b1, e["stride"])).to(self.dtype)
            kq2, sw2, b2 = e["c2"]
            yq, sy = self._quant_x(y, f"b{i}_mid", records)
            y = int8_conv(yq, kq2, sy, sw2, b2, 1)
            if "down" in e:
                kqd, swd, bd = e["down"]
                res = int8_conv(xq, kqd, sx, swd, bd, e["stride"])
            else:
                res = x.float()
            x = F.relu(y + res).to(self.dtype)
            if e["last"]:
                feats.append(x)
        c3, c4, c5 = feats

        p5 = self._conv_float(c5, *self.lats[5]).to(self.dtype)
        p4 = self._conv_float(c4, *self.lats[4]).to(self.dtype) + _upsample2(p5)
        p3 = self._conv_float(c3, *self.lats[3]).to(self.dtype) + _upsample2(p4)

        outputs = {}
        A = NUM_ANCHORS
        for lvl, (stride, feat, sm) in enumerate(zip(STRIDES, (p3, p4, p5), self.smooth)):
            h = self._int8_conv(feat, sm, 1, f"smooth{lvl}", records)
            for t, tw in enumerate(self.towers):
                h = self._int8_conv(h, tw, 1, f"tw{lvl}_{t}", records)
            B = h.shape[0]
            y = self._conv_float(h, *self.head_out)
            outputs[stride] = {
                "scores": y[..., :A].reshape(B, -1),
                "bbox": y[..., A:5 * A].reshape(B, -1, 4),
                "kps": y[..., 5 * A:].reshape(B, -1, 10),
            }
        return outputs

    def calibrate(self, images: torch.Tensor):
        """Forward pass recording the max-abs activation at every quantize point."""
        records: Dict[str, torch.Tensor] = {}
        return self(images, records), records


def calibrate_det_act_scales(detector: ScrfdDetector, canvas_batches: Iterable[torch.Tensor],
                             margin: float = 1.0) -> Dict[str, float]:
    """Post-training calibration of the detector's activation scales.

    ``canvas_batches``: (B, H·p, W·p, 3) NORMALIZED detection canvases, the
    tensors the serving graph feeds the detector (pooled, (x−127.5)/128).
    Returns {quant_point: scale} for ``ScrfdInt8Runner(act_scales=…)``.
    """
    runner = ScrfdInt8Runner(detector)
    maxes: Optional[Dict[str, float]] = None
    for batch in canvas_batches:
        _, records = runner.calibrate(batch)
        maxes = merge_max(maxes, records)
    if maxes is None:
        raise ValueError("no calibration batches provided")
    return {k: static_scale(v, margin) for k, v in maxes.items()}


__all__ = ["ScrfdInt8Runner", "calibrate_det_act_scales"]
