"""SCRFD-style face detector, written plainly from its flax variable tree.

A residual backbone (two stride-2 ConvBN layers, then three stages of two
residual blocks at widths 64, 128, 256), an FPN neck (1×1 laterals, nearest
2× upsampling, a 3×3 ConvBN smoothing each level) and one head shared by the
strides 8, 16 and 32 (two 3×3 ConvBN layers, then 3×3 convolutions with
bias giving per location and anchor a score, four box distances and ten
landmark offsets). BatchNorm eps 1e-5, ReLU. Anchors: two per location at
the location's corner ``(x, y) · stride``, flattened row-major then by
anchor. Boxes decode as ``center ∓ distance · stride``, landmarks as
``center + offset · stride``.

The serving frames are pooled 2× to the 320² canvas here (average of each
2×2 block) before the stem; the program folds that pool into its first
convolution, which computes the same sum.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .nn import Operands, avg_pool2, conv

STRIDES = (8, 16, 32)
ANCHORS = 2
EPS = 1e-5


def tree_to_torch(tree: dict, device) -> Dict[str, torch.Tensor]:
    """A flax tree {"params", "batch_stats"} as flat "a/b/c" keys → float32
    tensors on ``device``; conv kernels HWIO → OIHW."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
            return
        t = torch.as_tensor(np.asarray(node, np.float32))
        if path.endswith("kernel") and t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        flat[path] = t.contiguous().to(device)

    walk(tree, "")
    return flat


class Detector:
    def __init__(self, weights: Dict[str, torch.Tensor], P: Operands):
        self.w, self.P = weights, P

    def _bn(self, x, name):
        w = self.w
        mean, var = w[f"batch_stats/{name}/mean"], w[f"batch_stats/{name}/var"]
        scale, bias = w[f"params/{name}/scale"], w[f"params/{name}/bias"]
        inv = (torch.rsqrt(var + EPS) * scale)[None, :, None, None]
        return (x - mean[None, :, None, None]) * inv + bias[None, :, None, None]

    def _conv(self, x, name, stride=1, bias=False):
        b = self.w[f"params/{name}/bias"] if bias else None
        return conv(x, self.w[f"params/{name}/kernel"], self.P, stride, bias=b)

    def _convbn(self, x, name, stride=1):
        return F.relu(self._bn(self._conv(x, f"{name}/Conv_0", stride), f"{name}/BatchNorm_0"))

    def _resblock(self, x, name, stride):
        y = self._convbn(x, f"{name}/_ConvBN_0", stride)
        y = self._bn(self._conv(y, f"{name}/Conv_0"), f"{name}/BatchNorm_0")
        if f"params/{name}/Conv_1/kernel" in self.w:
            x = self._bn(self._conv(x, f"{name}/Conv_1", stride), f"{name}/BatchNorm_1")
        return F.relu(y + x)

    def _head(self, x) -> Dict[str, torch.Tensor]:
        x = self._convbn(x, "head/tower0")
        x = self._convbn(x, "head/tower1")
        B = x.shape[0]

        def flat(y, k):
            return y.permute(0, 2, 3, 1).reshape(B, -1, k)

        return {"scores": flat(self._conv(x, "head/cls", bias=True), 1)[..., 0],
                "bbox": flat(self._conv(x, "head/box", bias=True), 4),
                "kps": flat(self._conv(x, "head/kps", bias=True), 10)}

    def __call__(self, canvas: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        """canvas: (B, H, W, 3) normalized ((x − 127.5) / 128)."""
        x = canvas.permute(0, 3, 1, 2)
        x = self._convbn(x, "_ConvBN_0", 2)
        x = self._convbn(x, "_ConvBN_1", 2)
        feats = []
        for i in range(6):
            x = self._resblock(x, f"_ResBlock_{i}", 2 if i % 2 == 0 else 1)
            if i % 2 == 1:
                feats.append(x)
        c3, c4, c5 = feats
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        p5 = self._conv(c5, "lat5", bias=True)
        p4 = self._conv(c4, "lat4", bias=True) + up(p5)
        p3 = self._conv(c3, "lat3", bias=True) + up(p4)
        levels = [self._convbn(p, f"smooth{i}") for i, p in enumerate((p3, p4, p5))]
        return {s: self._head(f) for s, f in zip(STRIDES, levels)}


def anchor_centers(size: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, 2) anchor centers in canvas pixels and (A,) their strides."""
    H, W = size
    centers, strides = [], []
    for s in STRIDES:
        ys, xs = torch.meshgrid(torch.arange(H // s), torch.arange(W // s), indexing="ij")
        c = torch.stack([xs, ys], -1).reshape(-1, 2).float() * s
        centers.append(c.repeat_interleave(ANCHORS, 0))
        strides.append(torch.full((c.shape[0] * ANCHORS,), float(s)))
    return torch.cat(centers).to(device), torch.cat(strides).to(device)


def detect_all(det: Detector, frames: torch.Tensor, canvas_size: Tuple[int, int]):
    """Every anchor's score, box and landmarks for uint8 serving frames
    (B, S, S, 3), in serving coordinates: (scores (B, A), boxes (B, A, 4),
    landmarks (B, A, 5, 2))."""
    x = frames.float()
    ratio = x.shape[1] // canvas_size[0]
    while x.shape[1] > canvas_size[0]:
        x = avg_pool2(x)
    outs = det((x - 127.5) / 128.0)
    scores = torch.sigmoid(torch.cat([outs[s]["scores"] for s in STRIDES], 1))
    dist = torch.cat([outs[s]["bbox"] for s in STRIDES], 1)
    kps = torch.cat([outs[s]["kps"] for s in STRIDES], 1)
    centers, strides = anchor_centers(canvas_size, frames.device)
    d = dist * strides[:, None]
    boxes = torch.cat([centers - d[..., :2], centers + d[..., 2:]], -1)
    lms = kps.reshape(*kps.shape[:-1], 5, 2) * strides[:, None, None] + centers[:, None, :]
    # A canvas pixel's center is at r·u + (r − 1)/2 in serving pixels.
    shift = 0.5 * (ratio - 1)
    return scores, boxes * ratio + shift, lms * ratio + shift
