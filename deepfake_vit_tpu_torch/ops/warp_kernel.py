"""The three kernels of the serving warps: fractional window crop, pooled
window crop and the legacy-tap affine warp, hand-written in CUDA C++ for
Hopper (``csrc/warp.cu``).

Each wrapper here checks its inputs, allocates the output with
``torch.empty`` and launches its kernel on the current stream when the
tensors lie on a CUDA device; for CPU tensors it runs the plain PyTorch
version beside it, which computes the same function with the same rounding
points (tap weights rounded to bf16, the vertical pass rounded to the
pixel dtype, f32 sums of exact bf16×bf16 products). ``launches`` on each
wrapper counts kernel launches and nothing else.

The library is built on first use (``ops/cuda_build.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda_build import BUILD_DIR, NVCC_FLAGS, build_library, check, library, stream
from .umeyama import invert_affine

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "crop_frac", "crop_frac_plain",
           "crop_pool", "crop_pool_plain", "warp_affine_legacy", "warp_affine_legacy_plain"]


def _tri_bf16(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Tap weight bf16(max(0, 1 − |s − t|)), returned as float32."""
    return (1.0 - (s - t).abs()).clamp_min(0.0).to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# Fractional window crop
# ---------------------------------------------------------------------------


def crop_frac_plain(frames_flat, strip0, level, rfp, off_y, x0f, window: int,
                    channels: int, frame_idx) -> torch.Tensor:
    """Plain PyTorch version of the crop kernel (gathered taps).

    Arguments are the kernel's own (int32 per-face scalars, ``rfp`` the
    2⁻¹⁶ fixed-point resample factor); see :func:`crop_frac`.
    """
    B, H, WC = frames_flat.shape
    C = channels
    W = WC // C
    dev = frames_flat.device
    r = rfp.float() * (1.0 / 65536.0)
    i = torch.arange(window, dtype=torch.float32, device=dev)
    # Source coordinates of the window's pixel centers: strip-relative rows,
    # absolute columns.
    sy = off_y.float()[:, None] + (i + 0.5) * r[:, None] - 0.5  # (N, window)
    sx = x0f.float()[:, None] + (i + 0.5) * r[:, None] - 0.5
    lv = level.long()
    rows = torch.clamp_max(torch.full_like(lv, window) << lv, H)  # (N,)

    # Vertical pass: t1[n, o, :] = bf16(Σ_t V[o, t] · strip[t, :]).
    ty = torch.floor(sy).long()
    t1 = torch.zeros((strip0.shape[0], window, WC), dtype=torch.float32, device=dev)
    fi = frame_idx.long()[:, None]
    for dy in (0, 1):
        t = ty + dy
        row = strip0.long()[:, None] + t
        valid = (t >= 0) & (t < rows[:, None]) & (row >= 0) & (row < H)
        w = _tri_bf16(sy, t.float()) * valid
        src_row = row.clamp(0, H - 1)
        t1 = t1 + w[..., None] * frames_flat[fi, src_row].float()
    t1 = t1.to(frames_flat.dtype).float()

    # Horizontal pass: out[n, o, (jx, c)] = bf16(Σ_s t1[n, o, (s, c)] · Hx[s, jx]).
    tx = torch.floor(sx).long()
    cc = torch.arange(C, device=dev)
    out = torch.zeros((strip0.shape[0], window, window * C), dtype=torch.float32, device=dev)
    for dx in (0, 1):
        s = tx + dx
        valid = (s >= 0) & (s < W)
        hw = (_tri_bf16(sx, s.float()) * valid).repeat_interleave(C, dim=1)
        col = (s.clamp(0, W - 1)[:, :, None] * C + cc).reshape(s.shape[0], 1, window * C)
        picked = torch.gather(t1, 2, col.expand(-1, window, -1))
        out = out + picked * hw[:, None, :]
    return out.to(frames_flat.dtype)


def crop_frac(frames_flat: torch.Tensor, strip0: torch.Tensor, level: torch.Tensor,
              r: torch.Tensor, off_y: torch.Tensor, x0f: torch.Tensor,
              window: int, channels: int,
              frame_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fractional-scale window crop.

    frames_flat: (B, H, W·C) bf16 row-flattened frames; per face (N,):
    ``strip0`` level-0 strip start row, ``level`` strip bucket (rows
    ``min(window·2ˡ, H)``), ``r`` resample factor on the 2⁻¹⁶ grid,
    ``off_y`` strip-relative and ``x0f`` absolute integer-valued window
    starts, ``frame_idx`` source frame (default: identity). Returns
    (N, window, window·C) bf16: the window resampled at stride ``r`` with
    bilinear point taps, rows restricted to the face's strip and columns to
    the frame (taps outside read as border 0).
    """
    if frames_flat.dim() != 3 or frames_flat.shape[2] % channels:
        raise ValueError(f"frames_flat must be (B, H, W*{channels}), got {tuple(frames_flat.shape)}")
    if frames_flat.dtype != torch.bfloat16:
        raise TypeError(f"crop_frac takes bf16 frames, got {frames_flat.dtype}")
    if window <= 0:
        raise ValueError("window must be positive")
    N, H = strip0.shape[0], frames_flat.shape[1]
    if frame_idx is None:
        frame_idx = torch.arange(N, device=frames_flat.device)
    scalars = [
        strip0.to(torch.int32).contiguous(),
        level.to(torch.int32).contiguous(),
        frame_idx.to(torch.int32).contiguous(),
        torch.round(r.float() * 65536.0).to(torch.int32).contiguous(),
        off_y.to(torch.int32).contiguous(),
        x0f.to(torch.int32).contiguous(),
    ]
    dev = frames_flat.device
    if any(s.device != dev or s.shape != (N,) for s in scalars):
        raise ValueError("per-face scalars must be (N,) tensors on the frames' device")
    if dev.type == "cpu":
        return crop_frac_plain(frames_flat, *scalars[:2], scalars[3], *scalars[4:],
                               window=window, channels=channels, frame_idx=scalars[2])
    if dev.type != "cuda":
        raise RuntimeError(f"crop_frac has no kernel for device {dev}")
    frames_flat = frames_flat.contiguous()
    out = torch.empty((N, window, window * channels), dtype=torch.bfloat16, device=dev)
    lib = library()
    err = lib.dfv_crop_frac_bf16(
        frames_flat.data_ptr(), out.data_ptr(),
        *(s.data_ptr() for s in scalars),
        N, H, frames_flat.shape[2] // channels, channels, window, stream(),
    )
    check(err, "crop_frac")
    crop_frac.launches += 1
    return out


crop_frac.launches = 0


# ---------------------------------------------------------------------------
# Pooled window crop
# ---------------------------------------------------------------------------


def crop_pool_plain(frames_flat, y0_l0, x0, level, window: int, channels: int,
                    frame_idx) -> torch.Tensor:
    """Plain PyTorch version of the pooled crop kernel: per level present,
    gather each face's (window·2ˡ)² block and average its 2ˡ×2ˡ cells, rows
    first with one rounding to the pixel dtype in between.

    Arguments are the kernel's own (int32 per-face scalars); see
    :func:`crop_pool`.
    """
    B, H, WC = frames_flat.shape
    C = channels
    W = WC // C
    dev = frames_flat.device
    frames = frames_flat.reshape(B, H, W, C)
    out = torch.zeros((y0_l0.shape[0], window, window, C), dtype=frames_flat.dtype, device=dev)
    for l in sorted(set(level.tolist())):
        sel = torch.nonzero(level == l)[:, 0]
        side, wl = 1 << l, window << l
        span = torch.arange(wl, device=dev)
        rows = y0_l0[sel].long()[:, None] + span  # (n, wl) level-0 rows
        cols = (x0[sel].long()[:, None] << l) + span
        valid = ((rows >= 0) & (rows < H))[:, :, None] & ((cols >= 0) & (cols < W))[:, None, :]
        block = frames[frame_idx[sel].long()[:, None, None],
                       rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :]]
        block = block.float() * valid[..., None] * (1.0 / side)  # (n, wl, wl, C)
        t1 = block.reshape(-1, window, side, wl, C).sum(2).to(frames_flat.dtype).float()
        pooled = (t1 * (1.0 / side)).reshape(-1, window, window, side, C).sum(3)
        out[sel] = pooled.to(frames_flat.dtype)
    return out.reshape(-1, window, window * C)


def crop_pool(frames_flat: torch.Tensor, y0_l0: torch.Tensor, x0: torch.Tensor,
              level: torch.Tensor, window: int, channels: int,
              frame_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled window crops straight from level-0 frames.

    frames_flat: (B, H, W·C) bf16 row-flattened frames; per face (N,):
    ``y0_l0`` level-0 row offset (selected-level y0 << level), ``x0``
    selected-level column offset, ``level`` mip level, ``frame_idx`` source
    frame (default: identity). Returns (N, window, window·C) bf16: the
    window of the frame average-pooled ``level`` times by 2 — exact
    4ˡ-block averaging in f32, rows first, rounded to bf16 once in between
    and once at the end. Pixels outside the frame read as 0.
    """
    if frames_flat.dim() != 3 or frames_flat.shape[2] % channels:
        raise ValueError(f"frames_flat must be (B, H, W*{channels}), got {tuple(frames_flat.shape)}")
    if frames_flat.dtype != torch.bfloat16:
        raise TypeError(f"crop_pool takes bf16 frames, got {frames_flat.dtype}")
    if window <= 0:
        raise ValueError("window must be positive")
    N, H = y0_l0.shape[0], frames_flat.shape[1]
    dev = frames_flat.device
    if frame_idx is None:
        frame_idx = torch.arange(N, device=dev)
    scalars = [t.to(torch.int32).contiguous() for t in (y0_l0, x0, level, frame_idx)]
    if any(s.device != dev or s.shape != (N,) for s in scalars):
        raise ValueError("per-face scalars must be (N,) tensors on the frames' device")
    if dev.type == "cpu":
        return crop_pool_plain(frames_flat, *scalars[:3], window=window, channels=channels,
                               frame_idx=scalars[3])
    if dev.type != "cuda":
        raise RuntimeError(f"crop_pool has no kernel for device {dev}")
    frames_flat = frames_flat.contiguous()
    out = torch.empty((N, window, window * channels), dtype=torch.bfloat16, device=dev)
    err = library().dfv_crop_pool_bf16(
        frames_flat.data_ptr(), out.data_ptr(), *(s.data_ptr() for s in scalars),
        N, H, frames_flat.shape[2] // channels, channels, window, stream(),
    )
    check(err, "crop_pool")
    crop_pool.launches += 1
    return out


crop_pool.launches = 0


# ---------------------------------------------------------------------------
# Affine warp, legacy taps
# ---------------------------------------------------------------------------


def warp_affine_legacy_plain(images: torch.Tensor, coeffs: torch.Tensor,
                             out_size: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the warp kernel (gathered taps).

    images (B, Hs, Ws, C) bf16; coeffs (B, 6) f32 dst→src affine rows
    (a, b, c, d, e, f). Returns (B, Ho, Wo, C) f32.
    """
    B, Hs, Ws, C = images.shape
    Ho, Wo = out_size
    dev = images.device
    i = torch.arange(Ho, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(Wo, dtype=torch.float32, device=dev)[None, :]
    a, b, c, d, e, f = (coeffs[:, k, None, None] for k in range(6))
    sx = (a * j + b * i + c).reshape(B, -1)  # (B, Ho·Wo)
    sy = (d * j + e * i + f).reshape(B, -1)
    img = images.reshape(B, Hs * Ws, C).float()
    ty, tx = torch.floor(sy).long(), torch.floor(sx).long()

    out = torch.zeros((B, Ho * Wo, C), dtype=torch.float32, device=dev)
    for dx in (0, 1):
        s = tx + dx
        hw = _tri_bf16(sx, s.float()) * ((s >= 0) & (s < Ws))
        # P = bf16(Σ_t V[t] · img[t, s]) over the two vertical taps.
        p = torch.zeros_like(out)
        for dy in (0, 1):
            t = ty + dy
            vw = _tri_bf16(sy, t.float()) * ((t >= 0) & (t < Hs))
            flat = t.clamp(0, Hs - 1) * Ws + s.clamp(0, Ws - 1)
            px = torch.gather(img, 1, flat[..., None].expand(-1, -1, C))
            p = p + vw[..., None] * px
        p = p.to(torch.bfloat16).float()
        out = out + (p * hw[..., None]).to(torch.bfloat16).float()
    return out.reshape(B, Ho, Wo, C)


def warp_affine_legacy(images: torch.Tensor, matrices: torch.Tensor,
                       out_size: Tuple[int, int], inverse: bool = False) -> torch.Tensor:
    """Batched cv2.warpAffine equivalent (bilinear, border 0), bf16 taps.

    images: (B, Hs, Ws, C), cast to bf16; matrices: (B, 2, 3) src→dst
    affines (inverted here unless ``inverse``). Returns (B, Ho, Wo, C) f32.
    Per output pixel: sx = a·j + b·i + c, sy = d·j + e·i + f; tap weights
    bf16(max(0, 1−|s−t|)); P = bf16(Σ_t V·img); out = Σ_s f32(bf16(P·H)).
    """
    if images.dim() != 4:
        raise ValueError(f"images must be (B, Hs, Ws, C), got {tuple(images.shape)}")
    B, Hs, Ws, C = images.shape
    Ho, Wo = (int(v) for v in out_size)
    if matrices.shape != (B, 2, 3):
        raise ValueError(f"matrices must be ({B}, 2, 3), got {tuple(matrices.shape)}")
    A_inv = matrices if inverse else invert_affine(matrices)
    coeffs = A_inv.reshape(B, 6).float().contiguous()
    images = images.to(torch.bfloat16).contiguous()
    dev = images.device
    if coeffs.device != dev:
        raise ValueError("matrices must lie on the images' device")
    if dev.type == "cpu":
        return warp_affine_legacy_plain(images, coeffs, (Ho, Wo))
    if dev.type != "cuda":
        raise RuntimeError(f"warp_affine_legacy has no kernel for device {dev}")
    out = torch.empty((B, Ho, Wo, C), dtype=torch.float32, device=dev)
    lib = library()
    err = lib.dfv_warp_affine_legacy_bf16(
        images.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
        B, Hs, Ws, C, Ho, Wo, stream(),
    )
    check(err, "warp_affine_legacy")
    warp_affine_legacy.launches += 1
    return out


warp_affine_legacy.launches = 0
