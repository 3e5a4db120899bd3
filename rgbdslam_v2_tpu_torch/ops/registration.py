"""Pairwise 6-DoF registration: batched RANSAC with Mahalanobis inliers.

Port of ``rgbdslam_v2_tpu/ops/registration.py`` (``_sym3_solve``,
``mahalanobis_sq``, ``_gumbel_topk_sample``, ``ransac_register`` without the
projective refinement branch), batched over a leading candidate dimension
B where the JAX version is vmapped.

Hypothesis sampling draws Gumbel noise from a ``torch.Generator``; it cannot
reproduce ``jax.random``'s draws, so ``ransac_register`` takes an optional
``sample_idx`` that a parity test fills with the JAX indices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..core.alignment import weighted_kabsch, weighted_kabsch_quat
from ..core.noise import point_covariance_diag


class RegistrationResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) dst_T_src
    inliers: torch.Tensor  # (B, M) bool
    n_inliers: torch.Tensor  # (B,) int32
    rmse: torch.Tensor  # (B,) float32
    success: torch.Tensor  # (B,) bool


def _sym3_solve(S: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve S x = d for symmetric 3x3 S via the adjugate."""
    a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    e, f = S[..., 1, 1], S[..., 1, 2]
    i = S[..., 2, 2]
    A = e * i - f * f
    B = c * f - b * i
    C = b * f - c * e
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-18, torch.full_like(det, 1e-18), det)
    E = a * i - c * c
    F = b * c - a * f
    I = a * e - b * b
    x0 = A * d[..., 0] + B * d[..., 1] + C * d[..., 2]
    x1 = B * d[..., 0] + E * d[..., 1] + F * d[..., 2]
    x2 = C * d[..., 0] + F * d[..., 1] + I * d[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def mahalanobis_sq(T, src, dst, src_cov, dst_cov) -> torch.Tensor:
    """Squared Mahalanobis distance of dst vs T@src with
    Sigma = D_dst + R D_src R^T. T (..., 4, 4); points (..., M, 3)."""
    R = T[..., :3, :3]
    diff = se3.apply(T, src) - dst
    Rb = R[..., None, :, :]
    Sigma = (Rb * src_cov[..., None, :]) @ Rb.transpose(-1, -2) + torch.diag_embed(dst_cov)
    x = _sym3_solve(Sigma, diff)
    return (diff * x).sum(dim=-1)


def gumbel_topk_sample(generator: torch.Generator, logits: torch.Tensor,
                       n_hyp: int, k: int) -> torch.Tensor:
    """(B, M) logits -> (B, n_hyp, k) index sets without replacement,
    proportional to softmax(logits): k masked-argmax passes over Gumbel
    keys; -inf entries become finite keys descending by index, so rows
    with fewer than k finite logits still give k distinct indices."""
    B, M = logits.shape
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((B, n_hyp, M), generator=generator, device=logits.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny))) + logits[:, None, :]
    cols = torch.arange(M, device=logits.device)
    g = torch.where(torch.isfinite(g), g, -1e30 - cols.float() * 1e24)
    idxs = []
    for _ in range(k):
        i = torch.argmax(g, dim=-1)
        idxs.append(i)
        g = torch.where(cols == i[..., None], float("-inf"), g)
    return torch.stack(idxs, dim=-1)


def ransac_register(
    generator: Optional[torch.Generator],
    src_xyz: torch.Tensor,  # (B, M, 3) points in the NEW frame
    dst_xyz: torch.Tensor,  # (B, M, 3) points in the OLD frame
    match_dist: torch.Tensor,  # (B, M)
    match_valid: torch.Tensor,  # (B, M) bool
    cam_fx: float,
    cam_fy: float,
    n_hypotheses: int = 256,
    sample_size: int = 4,
    max_mahal_sq: float = 9.0,
    refine_iterations: int = 6,
    min_inliers: int = 12,
    sigma_depth: float = 0.01,
    sample_idx: Optional[torch.Tensor] = None,  # (B, n_hyp, k) injected draws
) -> RegistrationResult:
    """Batched RANSAC over B candidates' matched point pairs; dst_T_src.
    The identity is scored as one extra hypothesis."""
    B, M = match_valid.shape
    dev = src_xyz.device
    w_depth = torch.where(
        match_valid,
        1.0 / (torch.clamp(src_xyz[..., 2], min=1e-3) * torch.clamp(dst_xyz[..., 2], min=1e-3)),
        0.0,
    )
    src_cov = point_covariance_diag(src_xyz[..., 2], cam_fx, cam_fy, sigma_depth)
    dst_cov = point_covariance_diag(dst_xyz[..., 2], cam_fx, cam_fy, sigma_depth)

    # rank-biased hypothesis sampling (prefer small descriptor distance)
    order = torch.sort(torch.where(match_valid, match_dist, float("inf")), dim=-1,
                       stable=True).indices
    rank = torch.empty((B, M), device=dev).scatter_(
        1, order, torch.arange(M, device=dev, dtype=torch.float32).expand(B, M))
    logits = torch.where(match_valid, -rank * (4.0 / M), float("-inf"))
    if sample_idx is None:
        sample_idx = gumbel_topk_sample(generator, logits, n_hypotheses, sample_size)
    H = sample_idx.shape[1]
    flat_idx = sample_idx.reshape(B, -1)

    def take(x):  # (B, M, ...) -> (B, H, S, ...)
        idx = flat_idx.reshape(B, -1, *([1] * (x.dim() - 2))).expand(-1, -1, *x.shape[2:])
        return torch.gather(x, 1, idx).reshape(B, H, sample_size, *x.shape[2:])

    T_h = weighted_kabsch_quat(take(src_xyz), take(dst_xyz), take(w_depth))  # (B, H, 4, 4)
    eye4 = torch.eye(4, device=dev).expand(B, 1, 4, 4)
    T_h = torch.cat([T_h, eye4], dim=1)

    # isotropic Mahalanobis gate for the hypothesis sweep
    iso_var = (src_cov + dst_cov).mean(dim=-1)  # (B, M)
    diff = se3.apply(T_h, src_xyz[:, None]) - dst_xyz[:, None]  # (B, H+1, M, 3)
    m2 = (diff * diff).sum(dim=-1) / iso_var[:, None]
    inl = match_valid[:, None] & (m2 < max_mahal_sq)
    n_h = inl.sum(dim=-1, dtype=torch.int32)
    err_h = torch.where(inl, m2, 0.0).sum(dim=-1) / torch.clamp(n_h, min=1)
    quality = n_h.float() - err_h / (err_h + 1.0)
    best = torch.argmax(quality, dim=-1)  # (B,)
    bsel = torch.arange(B, device=dev)
    T = T_h[bsel, best]
    inliers = inl[bsel, best]

    # masked refits with the exact SVD fit and the full covariance model
    for _ in range(refine_iterations):
        w = torch.where(inliers, w_depth, 0.0)
        T2 = weighted_kabsch(src_xyz, dst_xyz, w)
        m2 = mahalanobis_sq(T2, src_xyz, dst_xyz, src_cov, dst_cov)
        inl2 = match_valid & (m2 < max_mahal_sq)
        better = inl2.sum(dim=-1) >= 3
        T = torch.where(better[:, None, None], T2, T)
        inliers = torch.where(better[:, None], inl2, inliers)

    m2 = mahalanobis_sq(T, src_xyz, dst_xyz, src_cov, dst_cov)
    inliers = match_valid & (m2 < max_mahal_sq)
    n_inl = inliers.sum(dim=-1, dtype=torch.int32)
    rmse = torch.sqrt(torch.where(inliers, m2, 0.0).sum(dim=-1) / torch.clamp(n_inl, min=1))
    return RegistrationResult(transform=T, inliers=inliers, n_inliers=n_inl,
                              rmse=rmse, success=n_inl >= min_inliers)
