"""Face alignment, written plainly: Umeyama's similarity by SVD, the pooled
window geometry, the pooled crop and an exact bilinear warp.

The pooled windowed warp cuts, per face, a ``window``² block from the frame
average-pooled 2ˡ times, at the smallest level ℓ whose scaled output quad
(plus a pixel each side) fits the window with 32 rows of slack, and warps
that block to the output with the dst→window affine. The level and the
block's start are the serving path's rules (they decide which pixels are
read); the crop and the warp here are exact float32 sums: no rounding of
the pooled pixels or of the bilinear weights.

Near a level boundary rounding decides the level. ``candidate_levels``
gives each face every level that a quad 1 % wider or narrower would pick, so
that the judge can accept the program's face under any of them.
"""

from __future__ import annotations

from typing import Tuple

import torch

REFERENCE_LANDMARKS = ((0.31, 0.32), (0.69, 0.32), (0.5, 0.55), (0.35, 0.75), (0.65, 0.75))
Y_ALIGN = 16
LEVEL_MARGIN = 0.01


def reference_points(out_size: Tuple[int, int], device) -> torch.Tensor:
    """(5, 2) target landmarks in output pixels."""
    Ho, Wo = out_size
    pts = torch.tensor(REFERENCE_LANDMARKS, dtype=torch.float64, device=device)
    return pts * torch.tensor([Wo, Ho], dtype=torch.float64, device=device)


def umeyama(src: torch.Tensor, dst: torch.Tensor, P=None) -> torch.Tensor:
    """Least-squares similarity (Umeyama 1991) mapping src → dst, by SVD in
    float64. src, dst: (N, K, 2). Returns (N, 2, 3) float64. ``P`` rounds
    the points, the operands of the products."""
    if P is not None:
        src, dst = P(src.float()), P(dst.float())
    src, dst = src.double(), dst.double()
    mu_s, mu_d = src.mean(1, keepdim=True), dst.mean(1, keepdim=True)
    s, d = src - mu_s, dst - mu_d
    cov = d.transpose(1, 2) @ s / src.shape[1]
    U, S, Vh = torch.linalg.svd(cov)
    sign = torch.ones_like(S)
    sign[:, 1] = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vh))
    R = U @ torch.diag_embed(sign) @ Vh
    var_s = (s * s).sum(-1).mean(-1)
    scale = (S * sign).sum(-1) / var_s
    sR = scale[:, None, None] * R
    t = mu_d[:, 0] - (sR @ mu_s[:, 0, :, None])[..., 0]
    return torch.cat([sR, t[..., None]], -1)


def invert(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (N, 2, 3) affines."""
    full = torch.cat([A, torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype,
                                      device=A.device).expand(A.shape[0], 1, 3)], 1)
    return torch.linalg.inv(full)[:, :2]


def apply(A: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ A[:, :, :2].transpose(1, 2) + A[:, None, :, 2]


def max_levels(src_hw: Tuple[int, int], window: int) -> int:
    H, W = src_hw
    levels = 1
    while (H % (2 ** levels) == 0 and W % (2 ** levels) == 0
           and (H >> levels) >= window and (W >> levels) >= window):
        levels += 1
    return levels


def _extent(A_inv: torch.Tensor, out_size: Tuple[int, int]):
    Ho, Wo = out_size
    a, b, c = A_inv[:, 0, 0], A_inv[:, 0, 1], A_inv[:, 0, 2]
    d, e, f = A_inv[:, 1, 0], A_inv[:, 1, 1], A_inv[:, 1, 2]
    jm, im = float(Wo - 1), float(Ho - 1)
    span_x = a.abs() * jm + b.abs() * im
    span_y = d.abs() * jm + e.abs() * im
    cx = (a * jm + b * im) * 0.5 + c
    cy = (d * jm + e * im) * 0.5 + f
    return span_x, span_y, cx, cy


def level_of(span_x, span_y, window: int, levels: int) -> torch.Tensor:
    level = torch.zeros(span_x.shape, dtype=torch.long, device=span_x.device)
    for l in range(levels - 1):
        fit = ((span_x / 2 ** l + 2.0) <= window - 1) & ((span_y / 2 ** l + 2.0) <= window - 2 * Y_ALIGN)
        level = level + (~fit).long()
    return level


def candidate_levels(A_inv: torch.Tensor, out_size, window: int, levels: int) -> torch.Tensor:
    """(N, levels) bool: the levels a quad within ``LEVEL_MARGIN`` of this
    face's would be cut at."""
    span_x, span_y, _, _ = _extent(A_inv.float(), out_size)
    ok = torch.zeros((A_inv.shape[0], levels), dtype=torch.bool, device=A_inv.device)
    rows = torch.arange(A_inv.shape[0], device=A_inv.device)
    for f in (1.0 - LEVEL_MARGIN, 1.0, 1.0 + LEVEL_MARGIN):
        ok[rows, level_of(span_x * f, span_y * f, window, levels)] = True
    return ok


def window_start(A_inv: torch.Tensor, out_size, src_hw, window: int, level: torch.Tensor):
    """The block's start (y0, x0) at ``level``, in that level's pixels."""
    Hs, Ws = src_hw
    _, _, cx, cy = _extent(A_inv.float(), out_size)
    scale = torch.exp2(-level.float())
    off = 0.5 * (1.0 - scale)
    cx_l, cy_l = cx * scale - off, cy * scale - off
    Wl, Hl = Ws >> level, Hs >> level
    x0 = torch.minimum(torch.round(cx_l - window / 2).long().clamp_min(0), Wl - window)
    y0 = (torch.floor((cy_l - window / 2) / Y_ALIGN).long() * Y_ALIGN).clamp_min(0)
    y0 = torch.minimum(y0, (Hl - window) // Y_ALIGN * Y_ALIGN)
    return y0, x0


def bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, P=None) -> torch.Tensor:
    """img (N, H, W, C) float32 sampled at (N, Ho, Wo) source coordinates,
    border 0 (cv2 INTER_LINEAR, BORDER_CONSTANT). ``P`` rounds the operands
    of the products: the pixels and the tap weights."""
    P = P or (lambda t: t)
    img = P(img)
    N, H, W, C = img.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = img.reshape(N, H * W, C)
    out = torch.zeros((*sx.shape, C), dtype=img.dtype, device=img.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = (x0 + dx).long(), (y0 + dy).long()
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, -1)
            px = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C)).reshape(out.shape)
            out = out + P(wx * wy * ok)[..., None] * px
    return P(out)


def pooled_warp(frames: torch.Tensor, A_inv: torch.Tensor, out_size, window: int,
                level: torch.Tensor, P=None) -> torch.Tensor:
    """Aligned faces (N, Ho, Wo, C) float32: each face's window at ``level``
    (N,) of its frame average-pooled 2^level times, warped by ``A_inv``
    (output → level-0 source) moved into the window."""
    N, Hs, Ws, C = frames.shape
    Ho, Wo = out_size
    out = torch.zeros((N, Ho, Wo, C), dtype=torch.float32, device=frames.device)
    A_inv = A_inv.float()
    y0, x0 = window_start(A_inv, out_size, (Hs, Ws), window, level)
    ii, jj = torch.meshgrid(torch.arange(Ho, dtype=torch.float32, device=frames.device),
                            torch.arange(Wo, dtype=torch.float32, device=frames.device),
                            indexing="ij")
    for l in sorted(set(level.tolist())):
        sel = torch.nonzero(level == l)[:, 0]
        img = frames[sel].float()
        for _ in range(l):
            img = img.reshape(-1, img.shape[1] // 2, 2, img.shape[2] // 2, 2, C).mean((2, 4))
        scale, off = 2.0 ** -l, 0.5 * (1.0 - 2.0 ** -l)
        rows = y0[sel][:, None] + torch.arange(window, device=frames.device)
        cols = x0[sel][:, None] + torch.arange(window, device=frames.device)
        block = img[torch.arange(len(sel), device=frames.device)[:, None, None],
                    rows[:, :, None], cols[:, None, :]]
        A = A_inv[sel]
        sx = (A[:, 0, 0, None, None] * jj + A[:, 0, 1, None, None] * ii + A[:, 0, 2, None, None])
        sy = (A[:, 1, 0, None, None] * jj + A[:, 1, 1, None, None] * ii + A[:, 1, 2, None, None])
        sx = sx * scale - off - x0[sel][:, None, None].float()
        sy = sy * scale - off - y0[sel][:, None, None].float()
        out[sel] = bilinear(block, sx, sy, P)
    return out


def align(landmarks: torch.Tensor, out_size, P=None):
    """Similarity transforms, their inverses and the aligned landmarks of
    the faces whose serving-frame landmarks (N, 5, 2) are given."""
    A = umeyama(landmarks, reference_points(out_size, landmarks.device).expand(
        landmarks.shape[0], -1, -1), P)
    return A, invert(A), apply(A, landmarks.double()).float()
