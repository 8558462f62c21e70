"""Batched Umeyama similarity estimation + 2×3 affine utilities.

For 2-D point sets the Umeyama (1991) solution needs no iterative SVD.
Write the cross-covariance as M = [[E+F, G−H], [G+H, E−F]]; then
M = Rot(φ)·diag(Q+R', Q−R')·Rot(θ) with Q = ‖(E, H)‖, R' = ‖(F, G)‖ and
φ+θ = atan2(H, E). Whether or not det M < 0 (the reflection guard flips
the sign of the second singular value), the optimal rotation is
Rot(atan2(H, E)) = [[E, −H], [H, E]] / Q and Σ Sᵢdᵢ = 2Q. So the whole
solve is elementwise and stays on the device: ``torch.linalg.svd`` on a
CUDA tensor synchronizes the device with the host, this does not.
"""

from __future__ import annotations

import torch


def umeyama(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Similarity transform (rotation+scale+translation) mapping src → dst.

    src, dst: (..., N, 2) point sets.
    Returns (..., 2, 3) affine matrices A with dst ≈ A @ [src, 1]ᵀ.
    """
    src = src.float()
    dst = dst.float()
    n = src.shape[-2]

    mu_src = src.mean(dim=-2, keepdim=True)  # (..., 1, 2)
    mu_dst = dst.mean(dim=-2, keepdim=True)
    src_d = src - mu_src
    dst_d = dst - mu_dst

    # Covariance (..., 2, 2) = dstᵀ src / n
    cov = torch.einsum("...ni,...nj->...ij", dst_d, src_d) / n
    var_src = (src_d * src_d).sum(dim=-1).mean(dim=-1)  # (...,)

    e = 0.5 * (cov[..., 0, 0] + cov[..., 1, 1])
    h = 0.5 * (cov[..., 1, 0] - cov[..., 0, 1])
    q = torch.hypot(e, h)
    trace = 2.0 * q  # Σ S·d
    q = q.clamp_min(1e-30)
    cos, sin = e / q, h / q
    R = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
    scale = trace / var_src.clamp_min(1e-12)

    sR = scale[..., None, None] * R
    t = mu_dst[..., 0, :] - torch.einsum("...ij,...j->...i", sR, mu_src[..., 0, :])
    return torch.cat([sR, t[..., :, None]], dim=-1)  # (..., 2, 3)


def affine_from_3pts(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact affine from 3 point pairs (cv2.getAffineTransform semantics).

    src, dst: (..., 3, 2). Returns (..., 2, 3). ``solve_ex`` without its
    error check: a singular system gives non-finite entries, as in JAX,
    and no host synchronization on the card."""
    src = src.float()
    M = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)  # (..., 3, 3)
    A_t, _ = torch.linalg.solve_ex(M, dst.float())  # M @ Aᵀ = dst
    return A_t.transpose(-1, -2)


def invert_affine(A: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices."""
    R = A[..., :2]
    t = A[..., 2]
    det = R[..., 0, 0] * R[..., 1, 1] - R[..., 0, 1] * R[..., 1, 0]
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    Rinv = (
        torch.stack(
            [R[..., 1, 1], -R[..., 0, 1], -R[..., 1, 0], R[..., 0, 0]], dim=-1
        ).reshape(A.shape[:-2] + (2, 2))
        * inv_det[..., None, None]
    )
    tinv = -torch.einsum("...ij,...j->...i", Rinv, t)
    return torch.cat([Rinv, tinv[..., :, None]], dim=-1)


def transform_points(A: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 2, 3) affines to (..., N, 2) points."""
    return torch.einsum("...ij,...nj->...ni", A[..., :2], pts) + A[..., None, :, 2]
