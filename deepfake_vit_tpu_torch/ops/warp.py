"""Batched affine warp with bilinear sampling and constant border.

``warp_affine`` is the exact gather formulation (cv2 INTER_LINEAR +
BORDER_CONSTANT=0) in float32, the reference the kernels are judged by.
``warp_affine_windowed`` is the serving path: per face, a window of
``window``² pixels taken from the original-resolution frame, then warped to
the output size — both steps through the hand-written kernels of
``ops/warp_kernel.py``. With ``fractional=True`` the window is resampled at
the factor ``r`` that fits the output quad (``window_geometry_frac``);
otherwise it is cut from the 2ˡ× average-pooled frame at the smallest mip
level ``l`` whose quad fits (``window_geometry``). ``warp_affine_auto``
warps whole images through the same warp kernels.

``tap_construction`` picks the warp kernel's taps as the JAX tap modes do:
"legacy", "uw" / "uw16" (rank-1 bf16 taps; one function) or "int8" (q7
vertical taps, s8 pixels). Any mode but "legacy" also switches the
fractional crop to its rank-1 "mxu" taps; the pooled crop has one function
for both constructions.

The geometry decides which pixels a crop reads, so it is computed in
float32 with the JAX package's operation order: the 16-aligned strip
start, ``r`` ceiled to the 2⁻¹⁶ grid, integer offsets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .umeyama import invert_affine
from .warp_kernel import WARP_KERNELS, crop_frac, crop_frac_mxu, crop_pool


def _bilinear_sample(images: torch.Tensor, frame_idx: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor, border_value: float) -> torch.Tensor:
    """images: (B, H, W, C); frame_idx: (N,) the frame each output reads;
    xs, ys: (N, Ho, Wo) source coords. Returns (N, Ho, Wo, C)."""
    B, H, W, C = images.shape
    flat = images.reshape(B * H * W, C)
    base = (frame_idx.long() * (H * W))[:, None, None]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = xs - x0
    wx0 = 1.0 - wx1
    wy1 = ys - y0
    wy0 = 1.0 - wy1

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        vals = flat[base + yc * W + xc]
        vals = torch.where(valid[..., None], vals, torch.full_like(vals, border_value))
        return w[..., None] * vals

    return (
        tap(x0, y0, wx0 * wy0)
        + tap(x1, y0, wx1 * wy0)
        + tap(x0, y1, wx0 * wy1)
        + tap(x1, y1, wx1 * wy1)
    )


def _bilinear_sample_one(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                         border_value: float) -> torch.Tensor:
    """img: (H, W, C); xs, ys: (Ho, Wo) source coords. Returns (Ho, Wo, C)."""
    zero = torch.zeros(1, dtype=torch.long, device=img.device)
    return _bilinear_sample(img[None], zero, xs[None], ys[None], border_value)[0]


def warp_affine(images: torch.Tensor, matrices: torch.Tensor, out_size: Tuple[int, int],
                border_value: float = 0.0, inverse: bool = False) -> torch.Tensor:
    """Batched cv2.warpAffine equivalent, float32.

    images: (B, H, W, C); matrices: (B, 2, 3) src→dst affines (inverted
    here unless ``inverse``). Returns (B, Ho, Wo, C).
    """
    Ho, Wo = out_size
    images = images.float()
    A_inv = matrices if inverse else invert_affine(matrices)
    dev = images.device
    ys, xs = torch.meshgrid(
        torch.arange(Ho, dtype=torch.float32, device=dev),
        torch.arange(Wo, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    outs = []
    for img, A in zip(images, A_inv.float()):
        sx = A[0, 0] * xs + A[0, 1] * ys + A[0, 2]
        sy = A[1, 0] * xs + A[1, 1] * ys + A[1, 2]
        outs.append(_bilinear_sample_one(img, sx, sy, border_value))
    return torch.stack(outs)


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_size: Tuple[int, int],
                    border_value: float = 0.0,
                    frame_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Box crops resized bilinearly, as the exact float32 warp: the JAX
    package's ``ops/warp.py::crop_and_resize``.

    images: (B, H, W, C); boxes: (N, 4) [x1, y1, x2, y2] in source pixels;
    ``frame_idx`` (N,): the frame each box is cut from (the identity when
    None, N = B). Returns (N, Ho, Wo, C) float32.
    """
    Ho, Wo = out_size
    images = images.float()
    boxes = boxes.float()
    dev = images.device
    if frame_idx is None:
        frame_idx = torch.arange(boxes.shape[0], device=dev)
    x1, y1, x2, y2 = boxes.unbind(-1)
    sx = ((x2 - x1) / Wo)[:, None, None]
    sy = ((y2 - y1) / Ho)[:, None, None]
    zeros = torch.zeros_like(sx)
    ys, xs = torch.meshgrid(torch.arange(Ho, dtype=torch.float32, device=dev),
                            torch.arange(Wo, dtype=torch.float32, device=dev), indexing="ij")
    src_x = sx * xs + zeros * ys + x1[:, None, None]
    src_y = zeros * xs + sy * ys + y1[:, None, None]
    return _bilinear_sample(images, frame_idx, src_x, src_y, border_value)


def _avg_pool2(images: torch.Tensor) -> torch.Tensor:
    B, H, W, C = images.shape
    return images.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def _quad_extent(A_inv: torch.Tensor, out_size: Tuple[int, int]):
    """Level-0 output-quad extent and center: (a, b, c, d, e, f, span_x,
    span_y, cx, cy) — the affine coefficients and the axis-aligned quad
    bounding-box span/center in source pixels."""
    Ho, Wo = out_size
    a, b, c = A_inv[:, 0, 0], A_inv[:, 0, 1], A_inv[:, 0, 2]
    d, e, f = A_inv[:, 1, 0], A_inv[:, 1, 1], A_inv[:, 1, 2]
    jm, im = float(Wo - 1), float(Ho - 1)
    span_x = a.abs() * jm + b.abs() * im
    span_y = d.abs() * jm + e.abs() * im
    cx = (a * jm + b * im) * 0.5 + c
    cy = (d * jm + e * im) * 0.5 + f
    return a, b, c, d, e, f, span_x, span_y, cx, cy


def max_window_levels(src_hw: Tuple[int, int], window: int) -> int:
    """Number of usable mip levels: every level must still contain a full
    window and keep the row-offset range 8-aligned."""
    H, W = src_hw
    levels = 1
    while (H % (2 ** levels) == 0 and W % (2 ** levels) == 0
           and (H >> levels) >= window and (W >> levels) >= window):
        levels += 1
    return levels


def window_geometry(A_inv: torch.Tensor, out_size: Tuple[int, int], src_hw: Tuple[int, int],
                    window: int, levels: int, y_align: int = 8):
    """Per-face mip level, crop offsets and window-space affine.

    A_inv: (N, 2, 3) dst→src affines in level-0 source coordinates. Returns
    (level (N,) int32, y0s (levels, N) int32, x0s (levels, N) int32 — the
    window's start at each level, in that level's pixels — and A_win
    (N, 2, 3) dst→window affines for the selected level).

    Level ℓ is the smallest whose 2⁻ˡ-scaled output quad (+1 px bilinear
    margin each side) fits the window with 2·``y_align`` rows of vertical
    slack for the aligned start. The quad may exceed the frame: taps outside
    the clipped window get zero weight, i.e. border 0.
    """
    Hs, Ws = src_hw
    A_inv = A_inv.float()
    a, b, c, d, e, f, span_x, span_y, cx, cy = _quad_extent(A_inv, out_size)

    # fits[ℓ] is monotone in ℓ, so level = #{ℓ < L−1 : not fits[ℓ]}.
    level = torch.zeros(a.shape, dtype=torch.int32, device=A_inv.device)
    for l in range(levels - 1):
        fit = ((span_x / float(2 ** l) + 2.0) <= float(window - 1)) & (
            (span_y / float(2 ** l) + 2.0) <= float(window - 2 * y_align))
        level = level + (~fit).to(torch.int32)

    y0s, x0s = [], []
    for l in range(levels):
        scale = 2.0 ** -l
        off = 0.5 * (1.0 - scale)  # pixel-center shift of 2× average pooling
        cx_l = cx * scale - off
        cy_l = cy * scale - off
        Wl, Hl = Ws >> l, Hs >> l
        x0s.append(torch.round(cx_l - window / 2).to(torch.int32).clamp(0, Wl - window))
        y0_raw = torch.floor((cy_l - window / 2) / y_align).to(torch.int32) * y_align
        y0s.append(y0_raw.clamp(0, (Hl - window) // y_align * y_align))
    y0s, x0s = torch.stack(y0s), torch.stack(x0s)

    idx = torch.arange(level.shape[0], device=A_inv.device)
    x0_sel = x0s[level.long(), idx]
    y0_sel = y0s[level.long(), idx]
    scale = torch.exp2(-level.float())
    off = 0.5 * (1.0 - scale)
    A_win = torch.stack(
        [
            torch.stack([a * scale, b * scale, c * scale - off - x0_sel], -1),
            torch.stack([d * scale, e * scale, f * scale - off - y0_sel], -1),
        ],
        dim=1,
    )
    return level, y0s, x0s, A_win


def frac_window_levels(src_h: int, window: int) -> int:
    """Strip-size buckets: rows at bucket ℓ are ``min(window·2ˡ, src_h)``;
    the top bucket is the whole frame height."""
    levels = 1
    while (window << (levels - 1)) < src_h:
        levels += 1
    return levels


def window_geometry_frac(A_inv: torch.Tensor, out_size: Tuple[int, int],
                         src_hw: Tuple[int, int], window: int, levels: int,
                         y_align: int = 8):
    """Fractional-scale window geometry: per-face resample factor ``r``.

    Returns (level (N,) int32 bucket, strip0s (levels, N) int32 level-0
    strip start rows, r (N,) f32 on the 2⁻¹⁶ grid, off_y (N,) f32
    strip-relative start, x0f (N,) f32 absolute x start, A_win (N, 2, 3)
    dst→window affines).
    """
    Hs, Ws = src_hw
    if window % y_align:
        raise ValueError(f"fractional window must be {y_align}-row aligned")
    A_inv = A_inv.float()
    a, b, c, d, e, f, span_x, span_y, cx, cy = _quad_extent(A_inv, out_size)
    dev = A_inv.device

    rows_l = [min(window << l, Hs) for l in range(levels)]
    # Quad + one window-px bilinear margin per side + 2 px for the integer
    # snap of the starts: window·r ≥ span + 2r + 2, ceiled to 2⁻¹⁶.
    r = ((torch.maximum(span_x, span_y) + 2.0) / float(window - 2)).clamp_min(1.0)
    r = torch.ceil(r * 65536.0) / 65536.0

    # Bucket ℓ must hold the fractional window plus alignment slack; bucket
    # 0 also accepts r == 1 quads that leave room for the aligned placement.
    level = torch.zeros(a.shape, dtype=torch.int32, device=dev)
    for l in range(levels - 1):
        fit = window * r + 2.0 * y_align <= rows_l[l]
        if l == 0:
            fit = fit | ((r <= 1.0) & (span_y + 2.0 + 2.0 * y_align <= window))
        level = level + (~fit).to(torch.int32)

    strip0s = []
    for l in range(levels):
        s_raw = torch.floor((cy - rows_l[l] / 2) / y_align).to(torch.int32) * y_align
        strip0s.append(s_raw.clamp(0, (Hs - rows_l[l]) // y_align * y_align))
    strip0s = torch.stack(strip0s)

    idx = torch.arange(level.shape[0], device=dev)
    strip0 = strip0s[level.long(), idx].float()
    rows_sel = torch.tensor(rows_l, dtype=torch.float32, device=dev)[level.long()]
    # Integer starts keep r == 1 windows bitwise-exact; A_win absorbs the
    # snap. A window taller than its strip (top bucket only) slides so the
    # whole frame stays covered.
    wr_y = window * r
    start_y = torch.floor(
        torch.clamp(
            cy - wr_y * 0.5,
            torch.minimum(strip0, strip0 + rows_sel - wr_y),
            torch.maximum(strip0, strip0 + rows_sel - wr_y),
        )
    )
    off_y = start_y - strip0
    wr = window * r
    zero = torch.zeros_like(wr)
    x0f = torch.floor(
        torch.clamp(cx - wr * 0.5, torch.minimum(zero, Ws - wr), torch.maximum(zero, Ws - wr))
    )

    # Window pixel centers sample source y = start + (i + 0.5)·r − 0.5.
    sh = 0.5 - 0.5 * r
    A_win = torch.stack(
        [
            torch.stack([a / r, b / r, (c - x0f + sh) / r], -1),
            torch.stack([d / r, e / r, (f - start_y + sh) / r], -1),
        ],
        dim=1,
    )
    return level, strip0s, r, off_y, x0f, A_win


def warp_affine_windowed(
    images: torch.Tensor,
    matrices: torch.Tensor,
    out_size: Tuple[int, int],
    window: int = 160,
    levels: Optional[int] = None,
    inverse: bool = False,
    frame_indices: Optional[torch.Tensor] = None,
    fractional: bool = False,
    tap_construction: str = "legacy",
) -> torch.Tensor:
    """Affine warp through a per-face window of the frame.

    Same contract as :func:`warp_affine` with border_value=0: images
    (B, Hs, Ws, C) are cast to bf16, ``frame_indices`` (N,) maps each of
    the N matrices to its frame (default identity). Returns (N, Ho, Wo, C)
    float32. Bitwise equal to the legacy-tap warp of the full frame
    whenever the quad fits the window at level 0 (r = 1).

    ``fractional=False`` (the default): the window is cut from the frame
    average-pooled ``level`` times (``window_geometry``; ``levels`` caps the
    mip levels, default ``max_window_levels``) by the pooled crop kernel.
    ``fractional=True``: the window is resampled at the per-face factor
    ``r`` with bilinear point taps (``window_geometry_frac``) by the
    fractional crop kernel; its strip buckets follow from the frame height.
    ``tap_construction``: see the module docstring.
    """
    warp = _warp_kernel(tap_construction)
    B, Hs, Ws, C = images.shape
    N = matrices.shape[0]
    if fractional:
        if levels is not None:
            raise ValueError("fractional=True derives its strip buckets from the frame "
                             "height (frac_window_levels); levels= is not supported")
        if Hs % 16:
            # The 16-aligned strip start cannot otherwise reach the bottom
            # Hs % 16 rows: pad zero rows, which sample as border 0 exactly.
            images = F.pad(images, (0, 0, 0, 0, 0, -Hs % 16))
            Hs += -Hs % 16
    elif levels is None:
        levels = max_window_levels((Hs, Ws), window)
    if min(Hs, Ws) < window:
        raise ValueError(f"window {window} exceeds source {Hs}×{Ws}")
    if Hs % 8 or window % 8:
        raise ValueError("source height and window must be multiples of 8")

    A_inv = matrices if inverse else invert_affine(matrices)
    frames_flat = images.to(torch.bfloat16).reshape(B, Hs, Ws * C)
    idx = torch.arange(N, device=A_inv.device)
    if fractional:
        level, strip0s, r, off_y, x0f, A_win = window_geometry_frac(
            A_inv, out_size, (Hs, Ws), window, frac_window_levels(Hs, window), y_align=16
        )
        crop_fn = crop_frac if tap_construction == "legacy" else crop_frac_mxu
        crop = crop_fn(frames_flat, strip0s[level.long(), idx], level, r, off_y, x0f,
                       window, C, frame_idx=frame_indices)
    else:
        # bf16 frames as in the fractional path, hence 16-row aligned starts.
        level, y0s, x0s, A_win = window_geometry(
            A_inv, out_size, (Hs, Ws), window, levels, y_align=16
        )
        y0_l0 = y0s[level.long(), idx] << level
        crop = crop_pool(frames_flat, y0_l0, x0s[level.long(), idx], level, window, C,
                         frame_idx=frame_indices)
    return warp(crop.reshape(N, window, window, C), A_win, out_size, inverse=True)


def _warp_kernel(tap_construction: str):
    if tap_construction not in WARP_KERNELS:
        raise ValueError(f"unknown tap construction {tap_construction!r}; "
                         f"expected one of {sorted(WARP_KERNELS)}")
    return WARP_KERNELS[tap_construction]


def warp_affine_auto(images: torch.Tensor, matrices: torch.Tensor, out_size: Tuple[int, int],
                     inverse: bool = False, tap_construction: str = "legacy") -> torch.Tensor:
    """Whole-image warp through the warp kernel of ``tap_construction``
    (bilinear, border 0; images cast to bf16). Returns (B, Ho, Wo, C)
    float32. The JAX function of this name runs its Pallas kernel on the
    TPU and the exact float32 warp elsewhere; here the kernel runs on a
    CUDA device and its plain version on the CPU."""
    return _warp_kernel(tap_construction)(images, matrices, out_size, inverse=inverse)
