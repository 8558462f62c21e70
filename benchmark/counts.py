"""Operations and bytes the work needs, counted from the reference's shapes.

Operations are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
a forward of the reference network on meta tensors (no arithmetic runs):
two per multiply-add of every convolution, linear layer and matrix product
(attention's QKᵀ and weights·V included). Normalization, activations,
pooling, softmax, the anchor decode, the alignment and quality are left
out: elementwise work, small beside the products.

Bytes of the pooled crop and the warp follow ``chip_smoke.py``'s counts
(``check_crop_pool``, ``warp_footprint_bytes``): the crop reads each face's
block of pooled source pixels that lies on the frame once (bf16), writes
its window once (bf16) and reads 16 bytes of scalars a face; the warp reads
the distinct window pixels that a bilinear tap with a nonzero bf16 weight
touches (bf16) and writes its float32 output once.
"""

from __future__ import annotations

import functools
import importlib
from typing import Dict, Sequence, Tuple

import torch

from .reference import effnet, vit
from .reference.nn import Operands

BF16 = 2
FLOAT32 = 4
CROP_SCALAR_BYTES = 16


def _flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _meta(spec) -> Dict[str, torch.Tensor]:
    return {name: torch.ones(shape, device="meta") for name, shape, _ in spec}


@functools.lru_cache(maxsize=None)
def detector_flops(canvas: Tuple[int, int], tree_shapes: Tuple[Tuple[str, tuple], ...],
                   arch: str = "scrfd") -> float:
    """Operations of one frame through the reference detector of family
    ``arch`` at ``canvas``; ``tree_shapes``: (flat key, shape) of its weights
    (``detector_shapes``)."""
    w = {k: torch.ones(s, device="meta") for k, s in tree_shapes}
    det = importlib.import_module(f"{__package__}.reference.detector_{arch}").Detector(w, Operands())
    return _flops(lambda: det(torch.ones((1, *canvas, 3), device="meta")))


def detector_shapes(weights: Dict[str, torch.Tensor]) -> Tuple[Tuple[str, tuple], ...]:
    return tuple(sorted((k, tuple(v.shape)) for k, v in weights.items()))


@functools.lru_cache(maxsize=None)
def effnet_flops(variant: str, image: int, hidden: Tuple[int, ...], classes: int) -> float:
    """Operations of one face through the EfficientNet classifier."""
    sd = _meta(effnet.param_spec(variant, hidden, classes))
    x = torch.ones((1, image, image, 3), device="meta")
    lms = torch.ones((1, 5, 2), device="meta")
    return _flops(lambda: effnet.forward(sd, x, lms, variant, hidden, Operands()))


@functools.lru_cache(maxsize=None)
def vit_flops(variant: str, image: int, classes: int) -> float:
    """Operations of one face through the ViT classifier."""
    sd = _meta(vit.param_spec(variant, image, classes))
    x = torch.ones((1, image, image, 3), device="meta")
    return _flops(lambda: vit.forward(sd, x, variant, Operands()))


def classifier_flops(model: dict, image: int) -> float:
    fe, clf = model.get("feature_extractor", {}), model.get("classifier", {})
    if model.get("type") == "vit":
        return vit_flops(fe.get("variant", "base16"), image, clf.get("num_classes", 2))
    hidden = tuple(clf.get("hidden_dims", (512, 128, 32)))
    return effnet_flops(fe.get("variant", "b4"), image, hidden, clf.get("num_classes", 2))



def _nonzero_tap(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Whether tap t of coordinate s has a nonzero bf16 weight."""
    return (1.0 - (s - t.float()).abs()).clamp_min(0.0).to(torch.bfloat16) > 0


def crop_pool_bytes(level: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                    src_hw: Tuple[int, int], window: int, channels: int = 3) -> int:
    """The pooled crop's bytes: ``level``, ``y0``, ``x0`` (N,) are each face's
    level and window start in that level's pixels."""
    H, W = src_hw
    side = 1 << level.long()

    def on_frame(lo, size):
        hi = torch.clamp((lo + window) * side, max=size)
        return (hi - torch.clamp(lo * side, min=0)).clamp_min(0)

    pixels = (on_frame(y0.long(), H) * on_frame(x0.long(), W)).sum().item()
    n = level.shape[0]
    return int(pixels) * channels * BF16 + n * window * window * channels * BF16 + n * CROP_SCALAR_BYTES


def warp_bytes(coeffs: torch.Tensor, src_hw: Tuple[int, int], out_size: Sequence[int],
               channels: int = 3) -> int:
    """The warp's bytes: ``coeffs`` (N, 6) dst→window affine rows (a, b, c,
    d, e, f) over an (Hs, Ws) window."""
    Hs, Ws = src_hw
    N = coeffs.shape[0]
    ii = torch.arange(out_size[0], dtype=torch.float32, device=coeffs.device)[:, None]
    jj = torch.arange(out_size[1], dtype=torch.float32, device=coeffs.device)[None, :]
    a, b, c, d, e, f = (coeffs[:, k, None, None].float() for k in range(6))
    sx = (a * jj + b * ii + c).reshape(N, -1)
    sy = (d * jj + e * ii + f).reshape(N, -1)
    ty, tx = torch.floor(sy).long(), torch.floor(sx).long()
    mask = torch.zeros((N, Hs * Ws + 1), dtype=torch.bool, device=coeffs.device)
    for dy in (0, 1):
        t = ty + dy
        vok = (t >= 0) & (t < Hs) & _nonzero_tap(sy, t)
        for dx in (0, 1):
            s = tx + dx
            ok = vok & (s >= 0) & (s < Ws) & _nonzero_tap(sx, s)
            mask.scatter_(1, torch.where(ok, t * Ws + s, torch.full_like(t, Hs * Ws)), True)
    read = int(mask[:, : Hs * Ws].sum().item()) * channels * BF16
    return read + N * out_size[0] * out_size[1] * channels * FLOAT32
