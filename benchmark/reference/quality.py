"""Face quality score, written plainly from its definition.

Six normalized checks, weighted 0.15, 0.25, 0.15, 0.15, 0.15, 0.15:
face size (the box's shorter side: s/100 below 100 px, 1 − (s − 500)/500
above 500, else 1), blur (variance of the 3×3 Laplacian with reflect-101
border, over 200, at most 1), brightness (1 − |mean grey − 127.5| / 127.5),
contrast (grey standard deviation over 100, at most 1), occlusion (the mean
over the five landmarks of the grey variance in a window of side
min(H, W)//10 centred on the landmark's truncated pixel and clipped to the
image, over 1000, at most 1) and the detection confidence. Grey is BT.601
luma; variances are population variances.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WEIGHTS = (0.15, 0.25, 0.15, 0.15, 0.15, 0.15)


def _box_sum(integral: torch.Tensor, y1, y2, x1, x2) -> torch.Tensor:
    """Sums over [y1, y2) × [x1, x2) from an (N, H+1, W+1) integral image."""
    n = torch.arange(integral.shape[0], device=integral.device)[:, None]
    return (integral[n, y2, x2] - integral[n, y1, x2] - integral[n, y2, x1]
            + integral[n, y1, x1])


def quality(faces: torch.Tensor, landmarks: torch.Tensor, boxes: torch.Tensor,
            confidence: torch.Tensor, P=None) -> torch.Tensor:
    """faces (N, H, W, 3) in [0, 255]; landmarks (N, 5, 2) in face pixels;
    boxes (N, 4) xyxy; confidence (N,). Returns (N,) scores in [0, 1].
    ``P`` rounds the pixels, the operands of every product here."""
    faces = (faces if P is None else P(faces.float())).double()
    gray = 0.299 * faces[..., 0] + 0.587 * faces[..., 1] + 0.114 * faces[..., 2]
    N, H, W = gray.shape
    pad = F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    lap = (pad[:, :-2, 1:-1] + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2] + pad[:, 1:-1, 2:]
           - 4.0 * gray)
    blur = lap.var(dim=(1, 2), unbiased=False)
    brightness = gray.mean(dim=(1, 2))
    contrast = gray.std(dim=(1, 2), unbiased=False)

    half = max(min(H, W) // 10, 2) // 2
    x = landmarks[..., 0].double().trunc().long()
    y = landmarks[..., 1].double().trunc().long()
    x1, x2 = (x - half).clamp(0, W), (x + half).clamp(0, W)
    y1, y2 = (y - half).clamp(0, H), (y + half).clamp(0, H)
    integral = F.pad(gray.cumsum(1).cumsum(2), (1, 0, 1, 0))
    integral2 = F.pad((gray * gray).cumsum(1).cumsum(2), (1, 0, 1, 0))
    area = (x2 - x1) * (y2 - y1)
    n = area.clamp_min(1).double()
    mean = _box_sum(integral, y1, y2, x1, x2) / n
    var = _box_sum(integral2, y1, y2, x1, x2) / n - mean * mean
    var = torch.where(area > 0, var, torch.zeros_like(var))
    occlusion = (var.mean(-1) / 1000.0).clamp_max(1.0)

    side = torch.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]).double()
    size = torch.where(side < 100.0, side / 100.0,
                       torch.where(side > 500.0, (1.0 - (side - 500.0) / 500.0).clamp_min(0.0),
                                   torch.ones_like(side)))
    checks = (size, (blur / 200.0).clamp_max(1.0),
              (1.0 - (brightness - 127.5).abs() / 127.5).clamp_min(0.0),
              (contrast / 100.0).clamp_max(1.0), occlusion, confidence.double())
    return sum(w * c for w, c in zip(WEIGHTS, checks)).float()
