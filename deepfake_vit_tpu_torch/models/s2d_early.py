"""Space-to-depth early stages of the EfficientNet backbone (serving path).

Counterpart of ``deepfake_vit_tpu/models/s2d_early.py``. The stem and the
blocks up to and including the first stride-2 block after block 0 (blocks
0-2 of b4, 0-1 of b0: the S/2² portion of the network) are re-expressed on
a block-4 space-to-depth layout, where every tensor lives at S/4² with
four times the channels:

- the image becomes (48, S/4, S/4) and the stride-2 stem an exact k2 conv
  over the 48 phase-major input channels ``(py·4 + px)·3 + c``;
- the stride-1 depthwise convs become grouped k3 convs over the four
  phases of each channel (channel-major layout ``c·4 + phase``);
- the first stride-2 depthwise collapses the phases back to a plain
  S/4² map, the input of flat block ``resume_block``.

The kernels are assembled from the stem's and blocks' weights by the tap
algebra of XLA's SAME padding (``_phase_taps``), BatchNorm folded when the
runner is built. The rounding points are the JAX runner's: bf16 after
every SiLU and after every block, float32 bias adds, squeeze-excitation in
float32. The JAX module reaches no Pallas kernel (XLA ran its grouped
convolutions on the TPU), so stock ``F.conv2d`` with ``groups`` runs here.
The JAX header records the path as slower than the stock early stages on
the TPU; it is ported for parity and is off by default.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .efficientnet import EfficientNetBackbone
from .quant import fold_bn, hwio

Pads = Tuple[int, int]


def _same_pad_low(h: int, k: int, s: int) -> int:
    """XLA 'SAME' low padding for size h, kernel k, stride s."""
    total = max((math.ceil(h / s) - 1) * s + k - h, 0)
    return total // 2


def _phase_taps(k: int, s: int, b_in: int, b_out: int, h: int
                ) -> Tuple[List[Tuple[int, int, int, int]], int, int]:
    """Tap algebra for one axis of a conv re-expressed on s2d blocks.

    A conv (kernel k, stride s, SAME) maps input position ``s·O + dy − pad``
    to output position O. With the input on s2d blocks of ``b_in``
    (position ``b_in·i + p``) and the output on blocks of ``b_out``
    (position ``b_out·o + q``), s·b_out == b_in, the tap at (q, dy) lands
    on s2d row ``i + ky``, phase ``p``, where ``m = s·q + dy − pad``,
    ``ky = m // b_in``, ``p = m % b_in``.

    Returns (taps, ky_min, ky_max) with taps = [(ky, p, q, dy)].
    """
    if s * b_out != b_in:
        raise ValueError(f"stride {s} x output block {b_out} must equal the input block {b_in}")
    pad = _same_pad_low(h, k, s)
    taps = []
    for q in range(b_out):
        for dy in range(k):
            m = s * q + dy - pad
            taps.append((m // b_in, m % b_in, q, dy))
    return taps, min(t[0] for t in taps), max(t[0] for t in taps)


def _conv(x: torch.Tensor, w: torch.Tensor, pads: Pads, groups: int = 1) -> torch.Tensor:
    """Stride-1 conv of an NCHW tensor with an OIHW kernel and the same
    explicit (low, high) padding on both axes (negative values crop)."""
    lo, hi = pads
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, None, 1, 0, 1, groups)


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b[None, :, None, None]


def _per_phase_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n_phase: int
                      ) -> torch.Tensor:
    """1×1 conv applied identically to every phase of a channel-major map.

    x: (B, C·P, H, W) bf16, layout c·P + p; w: (C, D) bf16; b: (D,) f32.
    Returns (B, D·P, H, W) float32, layout d·P + p."""
    B, CP, H, W = x.shape
    y = torch.einsum("bcphw,cd->bdphw", x.view(B, CP // n_phase, n_phase, H, W), w)
    return (y.float() + b[None, :, None, None, None]).reshape(B, -1, H, W)


def _squeeze_excite(x: torch.Tensor, blk: Dict, n_phase: int) -> torch.Tensor:
    """Squeeze-excitation over (H, W, phases) of a channel-major map, in
    float32; the gate is rounded to the map's dtype before it multiplies."""
    B, CP, H, W = x.shape
    se = x.float().view(B, CP // n_phase, n_phase, H, W).mean(dim=(2, 3, 4))
    se = F.silu(se @ blk["se_rw"] + blk["se_rb"])
    se = torch.sigmoid(se @ blk["se_ew"] + blk["se_eb"])
    return x * se.repeat_interleave(n_phase, dim=1).to(x.dtype)[:, :, None, None]


class S2DEarlyRunner:
    """Callable: normalized NHWC images → the NCHW bf16 input of flat block
    ``resume_block``, computed in the s2d-4 domain.

    Built once from a backbone module (BatchNorm folded here), so build it
    again after the backbone's weights change. Finish the network with
    ``backbone(x, start_block=runner.resume_block)``.
    """

    def __init__(self, backbone: EfficientNetBackbone, image_size: int = 224):
        if image_size % 4:
            raise ValueError(f"image_size must be a multiple of 4, got {image_size}")
        self.variant = backbone.variant
        self.image_size = image_size
        blocks = backbone.blocks
        # Stem (s2) + the stage-1 s1 blocks + the first stage-2 block (s2).
        self.n_s1_blocks = next(i for i, b in enumerate(blocks[1:], 1) if b["stride"] == 2)
        self.resume_block = self.n_s1_blocks + 1
        h = image_size // 2  # the stock stem's output grid
        self.h_out = image_size // 4
        with torch.no_grad():
            w3, b3 = fold_bn(hwio(backbone.stem_conv), backbone.stem_bn)
            taps, ky0, ky1 = _phase_taps(3, 2, 4, 2, image_size)
            self._build_stem(w3, b3, taps, ky0, ky1 - ky0 + 1)
            self.s1 = [self._build_s1_block(getattr(backbone, f"block_{i}"), h)
                       for i in range(self.n_s1_blocks)]
            self.s2 = self._build_s2_block(getattr(backbone, f"block_{self.n_s1_blocks}"), h)

    # -- kernel assembly --------------------------------------------------

    def _build_stem(self, w3: torch.Tensor, bias: torch.Tensor, taps, ky0: int, ks: int) -> None:
        cin, cout = w3.shape[2], w3.shape[3]
        # HWIO; input channel (py·4 + px)·cin + c, output channel c·4 + qy·2 + qx.
        w2 = torch.zeros((ks, ks, 16 * cin, cout * 4), dtype=torch.float32, device=w3.device)
        for (ky, py, qy, dy) in taps:
            for (kx, px, qx, dx) in taps:
                ci = (py * 4 + px) * cin
                w2[ky - ky0, kx - ky0, ci:ci + cin, qy * 2 + qx::4] += w3[dy, dx]
        self.stem_w = w2.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        self.stem_b = bias.float().repeat_interleave(4)
        self.stem_pad = (-ky0, ks - 1 + ky0)

    @staticmethod
    def _dw_phase_kernel(wdw: torch.Tensor, h: int, stride: int, b_out: int
                         ) -> Tuple[torch.Tensor, Pads]:
        """Depthwise kernel (k, k, 1, C) → grouped s2d kernel, OIHW bf16.

        Input layout c·4 + (py·2 + px), groups = C of 4 phases each; output
        c·b_out² + (qy·b_out + qx) (b_out = 2 for s1, 1 for s2)."""
        k, C = wdw.shape[0], wdw.shape[3]
        taps, ky0, ky1 = _phase_taps(k, stride, 2, b_out, h)
        ks = ky1 - ky0 + 1
        w = torch.zeros((ks, ks, 4, C * b_out * b_out), dtype=torch.float32, device=wdw.device)
        for (ky, py, qy, dy) in taps:
            for (kx, px, qx, dx) in taps:
                w[ky - ky0, kx - ky0, py * 2 + px, qy * b_out + qx::b_out * b_out] += wdw[dy, dx, 0]
        return w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(), (-ky0, ks - 1 + ky0)

    @staticmethod
    def _se_weights(blk) -> Dict[str, torch.Tensor]:
        return dict(se_rw=hwio(blk.se_reduce)[0, 0], se_rb=blk.se_reduce.bias.detach().float(),
                    se_ew=hwio(blk.se_expand)[0, 0], se_eb=blk.se_expand.bias.detach().float())

    def _build_s1_block(self, blk, h: int) -> Dict:
        wdw, bdw = fold_bn(hwio(blk.depthwise_conv), blk.bn1)
        wk, pad = self._dw_phase_kernel(wdw, h, 1, 2)
        wpr, bpr = fold_bn(hwio(blk.project_conv), blk.bn2)
        return dict(dw_w=wk, dw_pad=pad, dw_b=bdw.float().repeat_interleave(4),
                    **self._se_weights(blk), pr_w=wpr[0, 0].to(torch.bfloat16),
                    pr_b=bpr.float(), cin=wk.shape[0] // 4)

    def _build_s2_block(self, blk, h: int) -> Dict:
        wex, bex = fold_bn(hwio(blk.expand_conv), blk.bn0)
        wdw, bdw = fold_bn(hwio(blk.depthwise_conv), blk.bn1)
        wk, pad = self._dw_phase_kernel(wdw, h, 2, 1)
        wpr, bpr = fold_bn(hwio(blk.project_conv), blk.bn2)
        return dict(ex_w=wex[0, 0].to(torch.bfloat16), ex_b=bex.float(), dw_w=wk, dw_pad=pad,
                    dw_b=bdw.float(), **self._se_weights(blk),
                    pr_w=wpr[0, 0].to(torch.bfloat16), pr_b=bpr.float())

    # -- forward ----------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, S, S, 3) normalized NHWC, S == ``image_size``.
        Returns the (B, C, S/4, S/4) bf16 NCHW input of block ``resume_block``."""
        if images.dim() != 4 or tuple(images.shape[1:]) != (self.image_size, self.image_size, 3):
            raise ValueError(f"S2DEarlyRunner was built for ({self.image_size}, "
                             f"{self.image_size}, 3) images, got {tuple(images.shape)}")
        B, h = images.shape[0], self.h_out
        # s2d-4: (B, S, S, 3) → (B, h, 4, h, 4, 3) → (B, (py, px, c), h, h).
        x = images.reshape(B, h, 4, h, 4, 3).permute(0, 2, 4, 5, 1, 3).reshape(B, 48, h, h)
        x = x.to(torch.bfloat16)

        # Stem: dense k2 conv, 48 → 4·stem channels, channel-major phases.
        x = F.silu(_conv(x, self.stem_w, self.stem_pad).float() + _bias(self.stem_b))
        x = x.to(torch.bfloat16)

        # Stage-1 blocks: grouped 4-phase depthwise, SE, per-phase projection.
        for blk in self.s1:
            inp = x
            y = _conv(x, blk["dw_w"], blk["dw_pad"], groups=blk["cin"])
            y = F.silu(y.float() + _bias(blk["dw_b"])).to(torch.bfloat16)
            y = _squeeze_excite(y, blk, 4)
            y = _per_phase_matmul(y, blk["pr_w"], blk["pr_b"], 4).to(torch.bfloat16)
            x = y + inp if y.shape == inp.shape else y

        # The first stage-2 block: expand, s2 depthwise (collapses the
        # phases), then SE and projection on the plain map.
        blk = self.s2
        x = F.silu(_per_phase_matmul(x, blk["ex_w"], blk["ex_b"], 4)).to(torch.bfloat16)
        x = _conv(x, blk["dw_w"], blk["dw_pad"], groups=x.shape[1] // 4)
        x = F.silu(x.float() + _bias(blk["dw_b"])).to(torch.bfloat16)
        x = _squeeze_excite(x, blk, 1)
        x = torch.einsum("bchw,cd->bdhw", x, blk["pr_w"]).float() + _bias(blk["pr_b"])
        return x.to(torch.bfloat16)


__all__ = ["S2DEarlyRunner"]
