"""Weighted rigid alignment from 3D correspondences, closed form.

Port of ``rgbdslam_v2_tpu/core/alignment.py``: ``weighted_kabsch`` (SVD),
``weighted_kabsch_quat`` (Horn's quaternion by shifted power iteration, the
RANSAC hypothesis fit) and ``horn_align_trajectories``.
"""
from __future__ import annotations

import torch

from .. import backend
from . import se3

_Q0 = (0.8, 0.35, 0.3, 0.25)  # power-iteration start (w, x, y, z)


def _centered_cross_cov(src, dst, w):
    w = torch.clamp(w, min=0.0)
    wsum = w.sum(dim=-1, keepdim=True) + 1e-12
    wn = (w / wsum)[..., None]
    mu_s = (wn * src).sum(dim=-2)
    mu_d = (wn * dst).sum(dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", wn * sc, dc)
    return H, mu_s, mu_d


def weighted_kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Best-fit T with dst ~ T @ src (weights w >= 0). src, dst (..., N, 3)."""
    H, mu_s, mu_d = _centered_cross_cov(src, dst, w)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = V @ D @ Ut
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return se3.from_rt(R, t)


def weighted_kabsch_quat(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                         iters: int = 16) -> torch.Tensor:
    """Horn's quaternion fit: dominant eigenvector of the 4x4 N matrix by
    shifted power iteration (no SVD)."""
    S, mu_s, mu_d = _centered_cross_cov(src, dst, w)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        -2,
    )
    shift = 2.0 * S.abs().sum(dim=(-1, -2))[..., None, None] + 1e-6
    Ns = N + shift * torch.eye(4, dtype=N.dtype, device=N.device)
    q = backend.constant("kabsch_q0", lambda: torch.tensor(_Q0, dtype=N.dtype),
                         N.device).expand(*N.shape[:-1])
    for _ in range(iters):
        q = (Ns @ q[..., None])[..., 0]
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-20)
    q_xyzw = torch.cat([q[..., 1:], q[..., :1]], dim=-1)
    R = se3.quat_to_rot(q_xyzw)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return se3.from_rt(R, t)


def horn_align_trajectories(est: torch.Tensor, gt: torch.Tensor):
    """Align positions est (N, 3) to gt (N, 3). Returns (T, rmse)."""
    w = torch.ones(est.shape[:-1], dtype=est.dtype, device=est.device)
    T = weighted_kabsch(est, gt, w)
    aligned = se3.apply(T, est)
    err = torch.linalg.norm(aligned - gt, dim=-1)
    return T, torch.sqrt(torch.mean(err * err))
