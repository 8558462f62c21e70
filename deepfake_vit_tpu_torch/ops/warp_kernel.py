"""The kernels of the serving warps, hand-written in CUDA C++ for Hopper
(``csrc/warp.cu``): the fractional window crop with legacy taps
(``crop_frac``) or rank-1 taps (``crop_frac_mxu``), the pooled window crop
(``crop_pool``), and the affine warp with legacy taps
(``warp_affine_legacy``), rank-1 bf16 taps (``warp_affine_uw`` and
``warp_affine_uw16``: one function under the two names of the JAX tap
modes) or q7 int8 taps (``warp_affine_int8``).

Each wrapper here checks its inputs, allocates the output with
``torch.empty`` and launches its kernel on the current stream when the
tensors lie on a CUDA device; for CPU tensors it runs the plain PyTorch
version beside it, which computes the same function with the same rounding
points (tap weights rounded to bf16, the vertical pass rounded to the
pixel dtype, f32 sums of exact bf16×bf16 products). ``launches`` on each
wrapper counts kernel launches and nothing else.

The rank-1 taps are those of the TPU kernels' matmul construction:
``bf16(max(0, 1 − |U − 1|))`` with ``U = s + (1 − t)`` rounded once, where
the legacy taps take ``bf16(max(0, 1 − |s − t|))``.

The library is built on first use (``ops/cuda_build.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .cuda_build import (BUILD_DIR, NVCC_FLAGS, SMEM_PER_BLOCK, build_library, check, library,
                         stream)
from .umeyama import invert_affine

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "WARP_KERNELS", "CropFracPlan", "build_library",
           "crop_frac", "crop_frac_mxu", "crop_frac_plain", "crop_frac_plan",
           "crop_pool", "crop_pool_plain", "warp_affine_int8", "warp_affine_int8_plain",
           "warp_affine_legacy", "warp_affine_legacy_plain", "warp_affine_uw",
           "warp_affine_uw16", "warp_affine_uw_plain"]

_TAPS = {"legacy": 0, "mxu": 1, "uw": 1, "uw16": 1}  # the kernels' ``taps`` argument


def _tri_bf16(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Tap weight bf16(max(0, 1 − |s − t|)), returned as float32."""
    return (1.0 - (s - t).abs()).clamp_min(0.0).to(torch.bfloat16).float()


def _tri_u_bf16(a: torch.Tensor, b) -> torch.Tensor:
    """Rank-1 tap weight bf16(max(0, 1 − |U − 1|)), U = a + b rounded once."""
    return (1.0 - ((a + b) - 1.0).abs()).clamp_min(0.0).to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# Fractional window crop
# ---------------------------------------------------------------------------


def crop_frac_plain(frames_flat, strip0, level, rfp, off_y, x0f, window: int,
                    channels: int, frame_idx, construction: str = "legacy") -> torch.Tensor:
    """Plain PyTorch version of the crop kernel (gathered taps).

    Arguments are the kernel's own (int32 per-face scalars, ``rfp`` the
    2⁻¹⁶ fixed-point resample factor); see :func:`crop_frac`.
    ``construction`` "mxu" takes the rank-1 taps: V from U = t + (1 − sy),
    Hx from U = sx + (1 − s).
    """
    rank1 = construction == "mxu"
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
        w = (_tri_u_bf16(t.float(), 1.0 - sy) if rank1 else _tri_bf16(sy, t.float())) * valid
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
        w = _tri_u_bf16(sx, (1 - s).float()) if rank1 else _tri_bf16(sx, s.float())
        hw = (w * valid).repeat_interleave(C, dim=1)
        col = (s.clamp(0, W - 1)[:, :, None] * C + cc).reshape(s.shape[0], 1, window * C)
        picked = torch.gather(t1, 2, col.expand(-1, window, -1))
        out = out + picked * hw[:, None, :]
    return out.to(frames_flat.dtype)


class CropFracPlan(NamedTuple):
    """Launch plan of the fractional crop kernel (``crop_frac_band_kernel``)."""

    band: int          # output rows per block
    slot_bytes: int    # one staged source row at the largest r: the 16-byte superset of a frame row
    slot_budget: int   # shared-memory bytes for row slots; at least two slots
    smem_bytes: int    # the block's dynamic shared memory: slots and tap tables


_CROP_BAND = 8
_CROP_SLOT_BUDGET = 32 * 1024


def crop_frac_plan(window: int, channels: int, width: int) -> CropFracPlan:
    """Band height and shared memory of the crop kernel for one launch.

    A staged row spans the columns the output columns' taps touch, clipped
    to the frame, so at any r (the geometry's r has no upper bound: a quad
    larger than the frame gives r > H/window) a slot holds at most the
    16-byte-aligned superset of a whole frame row. The slot area holds at
    least two such rows, the two source rows of one output row, so a pass
    always makes progress; at r ~ 1 it holds a whole band. The tap tables
    take 12 bytes per output column and 36 per band row."""
    band = min(_CROP_BAND, window)
    slot_bytes = -(-width * channels * 2 // 16) * 16 + 16
    slot_budget = max(_CROP_SLOT_BUDGET, 2 * slot_bytes)
    smem = slot_budget + 12 * window + 36 * band
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"crop_frac: frames {width} wide with {channels} channels need "
                         f"{smem} bytes of shared memory a block, more than {SMEM_PER_BLOCK}")
    return CropFracPlan(band, slot_bytes, slot_budget, smem)


def _crop_frac(fn, construction: str, frames_flat, strip0, level, r, off_y, x0f,
               window: int, channels: int, frame_idx) -> torch.Tensor:
    if frames_flat.dim() != 3 or frames_flat.shape[2] % channels:
        raise ValueError(f"frames_flat must be (B, H, W*{channels}), got {tuple(frames_flat.shape)}")
    if frames_flat.dtype != torch.bfloat16:
        raise TypeError(f"{fn.__name__} takes bf16 frames, got {frames_flat.dtype}")
    if window <= 0:
        raise ValueError("window must be positive")
    N, H = strip0.shape[0], frames_flat.shape[1]
    W = frames_flat.shape[2] // channels
    dev = frames_flat.device
    scalars = (strip0, level, r, off_y, x0f) + (() if frame_idx is None else (frame_idx,))
    if any(s.device != dev or s.shape != (N,) for s in scalars):
        raise ValueError("per-face scalars must be (N,) tensors on the frames' device")
    if dev.type == "cpu":
        fidx = torch.arange(N) if frame_idx is None else frame_idx
        return crop_frac_plain(frames_flat, strip0.to(torch.int32), level.to(torch.int32),
                               torch.round(r.float() * 65536.0).to(torch.int32),
                               off_y.to(torch.int32), x0f.to(torch.int32), window, channels,
                               fidx.to(torch.int32), construction)
    if dev.type != "cuda":
        raise RuntimeError(f"{fn.__name__} has no kernel for device {dev}")
    if (window * channels) % 8 or N > 65535:
        raise ValueError(f"{fn.__name__}: the kernel takes window * channels a multiple of 8 "
                         f"and at most 65535 faces, got {window} * {channels} and {N}")
    plan = crop_frac_plan(window, channels, W)
    # The kernel's own types: no conversion launches when the geometry's
    # tensors are passed as they come.
    ints = [t.to(torch.int32).contiguous() for t in (strip0, level)]
    floats = [t.to(torch.float32).contiguous() for t in (r, off_y, x0f)]
    fidx = None if frame_idx is None else frame_idx.to(torch.int32).contiguous()
    frames_flat = frames_flat.contiguous()
    out = torch.empty((N, window, window * channels), dtype=torch.bfloat16, device=dev)
    err = library().dfv_crop_frac_bf16(
        frames_flat.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in ints),
        None if fidx is None else fidx.data_ptr(), *(t.data_ptr() for t in floats),
        N, H, W, channels, window, _TAPS[construction], plan.band, plan.slot_budget,
        plan.smem_bytes, stream(),
    )
    check(err, fn.__name__)
    fn.launches += 1
    return out


def crop_frac(frames_flat: torch.Tensor, strip0: torch.Tensor, level: torch.Tensor,
              r: torch.Tensor, off_y: torch.Tensor, x0f: torch.Tensor,
              window: int, channels: int,
              frame_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fractional-scale window crop, legacy taps.

    frames_flat: (B, H, W·C) bf16 row-flattened frames; per face (N,):
    ``strip0`` level-0 strip start row, ``level`` strip bucket (rows
    ``min(window·2ˡ, H)``), ``r`` resample factor on the 2⁻¹⁶ grid and at
    most 2⁸, ``off_y`` strip-relative and ``x0f`` absolute integer-valued
    window starts, ``frame_idx`` source frame (default: identity). Returns
    (N, window, window·C) bf16: the window resampled at stride ``r`` with
    bilinear point taps, rows restricted to the face's strip and columns to
    the frame (taps outside read as border 0).

    On a CUDA device the call launches the kernel and nothing else when the
    scalars come in the kernel's types, as ``window_geometry_frac`` makes
    them: ``strip0`` and ``level`` int32, ``r``, ``off_y`` and ``x0f``
    float32, ``frame_idx`` None or int32. Scalars of other types are
    converted first, and the conversion is work of the call. The kernel
    needs ``window·C`` a multiple of 8.
    """
    return _crop_frac(crop_frac, "legacy", frames_flat, strip0, level, r, off_y, x0f,
                      window, channels, frame_idx)


def crop_frac_mxu(frames_flat: torch.Tensor, strip0: torch.Tensor, level: torch.Tensor,
                  r: torch.Tensor, off_y: torch.Tensor, x0f: torch.Tensor,
                  window: int, channels: int,
                  frame_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`crop_frac` with the rank-1 taps of the TPU kernel's "mxu"
    construction, which every tap mode but "legacy" selects. The support
    of the taps is the legacy one; a weight inside it may differ by one
    bf16 rounding; at r = 1 the crop is still an exact copy."""
    return _crop_frac(crop_frac_mxu, "mxu", frames_flat, strip0, level, r, off_y, x0f,
                      window, channels, frame_idx)


crop_frac.launches = 0
crop_frac_mxu.launches = 0


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
# Affine warp: legacy, rank-1 (uw / uw16) and int8 taps
# ---------------------------------------------------------------------------


def _warp_coords(coeffs: torch.Tensor, out_size: Tuple[int, int]):
    """Source x and y of every output pixel, (B, Ho·Wo) each: a·j + b·i + c."""
    B = coeffs.shape[0]
    Ho, Wo = out_size
    i = torch.arange(Ho, dtype=torch.float32, device=coeffs.device)[:, None]
    j = torch.arange(Wo, dtype=torch.float32, device=coeffs.device)[None, :]
    a, b, c, d, e, f = (coeffs[:, k, None, None] for k in range(6))
    return (a * j + b * i + c).reshape(B, -1), (d * j + e * i + f).reshape(B, -1)


def _warp_bf16_plain(images, coeffs, out_size, rank1: bool) -> torch.Tensor:
    B, Hs, Ws, C = images.shape
    sx, sy = _warp_coords(coeffs, out_size)
    img = images.reshape(B, Hs * Ws, C).float()
    ty, tx = torch.floor(sy).long(), torch.floor(sx).long()

    def tap(s, t):
        return _tri_u_bf16(s, (1 - t).float()) if rank1 else _tri_bf16(s, t.float())

    out = torch.zeros((B, sx.shape[1], C), dtype=torch.float32, device=images.device)
    for dx in (0, 1):
        s = tx + dx
        hw = tap(sx, s) * ((s >= 0) & (s < Ws))
        # P = bf16(Σ_t V[t] · img[t, s]) over the two vertical taps.
        p = torch.zeros_like(out)
        for dy in (0, 1):
            t = ty + dy
            vw = tap(sy, t) * ((t >= 0) & (t < Hs))
            flat = t.clamp(0, Hs - 1) * Ws + s.clamp(0, Ws - 1)
            px = torch.gather(img, 1, flat[..., None].expand(-1, -1, C))
            p = p + vw[..., None] * px
        p = p.to(torch.bfloat16).float()
        out = out + (p * hw[..., None]).to(torch.bfloat16).float()
    return out.reshape(B, *out_size, C)


def warp_affine_legacy_plain(images: torch.Tensor, coeffs: torch.Tensor,
                             out_size: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the legacy-tap warp kernel (gathered taps).

    images (B, Hs, Ws, C) bf16; coeffs (B, 6) f32 dst→src affine rows
    (a, b, c, d, e, f). Returns (B, Ho, Wo, C) f32.
    """
    return _warp_bf16_plain(images, coeffs, out_size, rank1=False)


def warp_affine_uw_plain(images: torch.Tensor, coeffs: torch.Tensor,
                         out_size: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the rank-1 bf16 warp kernel ("uw" and
    "uw16"): :func:`warp_affine_legacy_plain` with the taps
    bf16(max(0, 1 − |(s + (1 − t)) − 1|))."""
    return _warp_bf16_plain(images, coeffs, out_size, rank1=True)


def warp_affine_int8_plain(images: torch.Tensor, coeffs: torch.Tensor,
                           out_size: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the int8 warp kernel, same arguments as
    :func:`warp_affine_legacy_plain`: pixels quantized to s8 as
    rint(p) − 128 (half to even), q7 vertical taps
    trunc(max(0.5, 127.5 − |U − 127.5|)) with U = 127·sy + (127(1 − t) + 0.5),
    rank-1 bf16 horizontal taps, P = bf16(Σ_t s8·V) (exact integer sum),
    out = (Σ_s f32(bf16(P·H)) + (128·ΣV)·ΣH) · f32(1/127); the sums of V and
    H run over the taps inside the source."""
    B, Hs, Ws, C = images.shape
    sx, sy = _warp_coords(coeffs, out_size)
    q = (torch.round(images.float()) - 128.0).clamp(-128.0, 127.0).reshape(B, Hs * Ws, C)
    ty, tx = torch.floor(sy).long(), torch.floor(sx).long()
    u0 = sy * 127.0
    vq, hw = [], []
    for d in (0, 1):
        t = ty + d
        u = u0 + ((127 * (1 - t)).float() + 0.5)
        v = torch.trunc((127.5 - (u - 127.5).abs()).clamp_min(0.5))
        vq.append(v * ((t >= 0) & (t < Hs)))
        s = tx + d
        hw.append(_tri_u_bf16(sx, (1 - s).float()) * ((s >= 0) & (s < Ws)))
    corr = ((vq[0] + vq[1]) * 128.0) * (hw[0] + hw[1])
    acc = torch.zeros((B, sx.shape[1], C), dtype=torch.float32, device=images.device)
    for dx in (0, 1):
        s = (tx + dx).clamp(0, Ws - 1)
        p = torch.zeros_like(acc)
        for dy in (0, 1):
            flat = (ty + dy).clamp(0, Hs - 1) * Ws + s
            p = p + vq[dy][..., None] * torch.gather(q, 1, flat[..., None].expand(-1, -1, C))
        p = p.to(torch.bfloat16).float()
        acc = acc + (p * hw[dx][..., None]).to(torch.bfloat16).float()
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32)
    return ((acc + corr[..., None]) * inv).reshape(B, *out_size, C)


_WARP_PLAIN = {"legacy": warp_affine_legacy_plain, "uw": warp_affine_uw_plain,
               "uw16": warp_affine_uw_plain, "int8": warp_affine_int8_plain}


def _warp_affine(fn, construction: str, images, matrices, out_size, inverse) -> torch.Tensor:
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
        return _WARP_PLAIN[construction](images, coeffs, (Ho, Wo))
    if dev.type != "cuda":
        raise RuntimeError(f"{fn.__name__} has no kernel for device {dev}")
    out = torch.empty((B, Ho, Wo, C), dtype=torch.float32, device=dev)
    ptrs = (images.data_ptr(), coeffs.data_ptr(), out.data_ptr(), B, Hs, Ws, C, Ho, Wo)
    if construction == "int8":
        err = library().dfv_warp_affine_int8(*ptrs, stream())
    else:
        err = library().dfv_warp_affine_bf16(*ptrs, _TAPS[construction], stream())
    check(err, fn.__name__)
    fn.launches += 1
    return out


def warp_affine_legacy(images: torch.Tensor, matrices: torch.Tensor,
                       out_size: Tuple[int, int], inverse: bool = False) -> torch.Tensor:
    """Batched cv2.warpAffine equivalent (bilinear, border 0), bf16 taps.

    images: (B, Hs, Ws, C), cast to bf16; matrices: (B, 2, 3) src→dst
    affines (inverted here unless ``inverse``). Returns (B, Ho, Wo, C) f32.
    Per output pixel: sx = a·j + b·i + c, sy = d·j + e·i + f; tap weights
    bf16(max(0, 1−|s−t|)); P = bf16(Σ_t V·img); out = Σ_s f32(bf16(P·H)).
    """
    return _warp_affine(warp_affine_legacy, "legacy", images, matrices, out_size, inverse)


def warp_affine_uw(images: torch.Tensor, matrices: torch.Tensor,
                   out_size: Tuple[int, int], inverse: bool = False) -> torch.Tensor:
    """:func:`warp_affine_legacy` with the rank-1 taps of the JAX tap mode
    "uw". The JAX kernel rounds the tap plane to bf16 in this mode too, so
    it is the same function as "uw16" (:func:`warp_affine_uw16`)."""
    return _warp_affine(warp_affine_uw, "uw", images, matrices, out_size, inverse)


def warp_affine_uw16(images: torch.Tensor, matrices: torch.Tensor,
                     out_size: Tuple[int, int], inverse: bool = False) -> torch.Tensor:
    """:func:`warp_affine_legacy` with the rank-1 bf16 taps of the JAX tap
    mode "uw16"."""
    return _warp_affine(warp_affine_uw16, "uw16", images, matrices, out_size, inverse)


def warp_affine_int8(images: torch.Tensor, matrices: torch.Tensor,
                     out_size: Tuple[int, int], inverse: bool = False) -> torch.Tensor:
    """The warp of the JAX tap mode "int8" (see :func:`warp_affine_int8_plain`
    for the arithmetic), same arguments as :func:`warp_affine_legacy`. The
    pixels are cast to bf16 first, which keeps uint8-range integers and the
    crop kernels' bf16 output exact; the kernel quantizes them in registers."""
    return _warp_affine(warp_affine_int8, "int8", images, matrices, out_size, inverse)


WARP_KERNELS = {"legacy": warp_affine_legacy, "uw": warp_affine_uw, "uw16": warp_affine_uw16,
                "int8": warp_affine_int8}
warp_affine_legacy.launches = 0
warp_affine_uw.launches = 0
warp_affine_uw16.launches = 0
warp_affine_int8.launches = 0
