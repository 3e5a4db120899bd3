"""Dense ICP refinement between two organized RGB-D point grids.

Port of ``rgbdslam_v2_tpu/ops/icp.py`` (``IcpResult``, ``grid_normals``,
``_subsample``, ``icp_point_to_plane``, ``_inv3x3_sym``,
``icp_plane_to_plane``), with a leading batch dimension where the JAX
package vmaps (one pair is a batch of one). Torch ops, with no host read:
the JAX ``lax.scan`` over the iterations is a Python loop of tensor ops,
and nothing branches on a tensor on the host, so the loop queues on the
card without waiting for it.

* Nearest neighbours are brute force, as in the JAX package: ``|m|^2 +
  |d|^2 - 2 m.d`` for every (source, destination) pair from one matrix
  product (float32, TF32 off) and the first index of the row minimum.
  Invalid destination points are parked at 1e6.
* The 80th percentile of the residuals is the JAX "linear" quantile: a
  sort, then the two neighbours of position 0.8 (n - 1) weighted in
  float32.
* The 6x6 normal equations are solved by Gauss-Jordan elimination without
  pivoting, written as tensor ops: H is symmetric positive definite (the
  seed prior adds 10 I), and a library solve may wait for the card to
  check its status.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se3


class IcpResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) refined dst_T_src
    rmse: torch.Tensor  # (B,) robust rms of the used pairs
    n_pairs: torch.Tensor  # (B,) int32 used correspondences (last iteration)
    converged: torch.Tensor  # (B,) bool


def grid_normals(points: torch.Tensor, valid: torch.Tensor,
                 max_edge: float = 0.1) -> torch.Tensor:
    """Normals of an organized (..., H, W, 3) point grid from the cross
    product of its central differences, oriented towards the camera; zero
    where a neighbour is invalid, a neighbour step exceeds max_edge metres
    (a depth discontinuity) or the cross product vanishes."""
    dx = torch.roll(points, -1, -2) - torch.roll(points, 1, -2)
    dy = torch.roll(points, -1, -3) - torch.roll(points, 1, -3)
    n = torch.linalg.cross(dx, dy)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-9)
    flip = (n * points).sum(-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    smooth = (torch.linalg.norm(dx, dim=-1) < max_edge) & (torch.linalg.norm(dy, dim=-1) < max_edge)
    nb_valid = (torch.roll(valid, -1, -1) & torch.roll(valid, 1, -1)
                & torch.roll(valid, -1, -2) & torch.roll(valid, 1, -2))
    ok = valid & nb_valid & smooth & (norm[..., 0] > 1e-9)
    return torch.where(ok[..., None], n, 0.0)


def _subsample(points, valid, stride: int):
    """(B, H, W, 3), (B, H, W) -> every stride-th row and column, flat."""
    B = points.shape[0]
    return (points[:, ::stride, ::stride].reshape(B, -1, 3),
            valid[:, ::stride, ::stride].reshape(B, -1))


def _inv3x3_sym(C: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of symmetric positive-definite (..., 3, 3)
    matrices from the adjugate (cross products of the columns)."""
    c0, c1, c2 = C[..., :, 0], C[..., :, 1], C[..., :, 2]
    r0 = torch.linalg.cross(c1, c2)
    r1 = torch.linalg.cross(c2, c0)
    r2 = torch.linalg.cross(c0, c1)
    det = (c0 * r0).sum(-1)[..., None, None]
    return torch.stack([r0, r1, r2], dim=-2) / torch.clamp(det, min=1e-12)


def _solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with H x = b for symmetric positive-definite (B, 6, 6) H, by
    Gauss-Jordan elimination on [H | b] without pivoting."""
    A = torch.cat([H, b[..., None]], dim=-1)
    for k in range(6):
        row = A[:, k] / A[:, k, k : k + 1]
        col = A[:, :, k].clone()
        col[:, k] = 0.0
        A = A - col[:, :, None] * row[:, None, :]
        A[:, k] = row
    return A[:, :, 6]


def _percentile80(absr: torch.Tensor) -> torch.Tensor:
    """jnp.percentile(absr, 80.0, axis=-1), method "linear": the sorted
    values at floor and ceil of q = 0.8 (n - 1), weighted in float32."""
    n = absr.shape[-1]
    q = np.float32(np.float32(80.0) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = int(np.floor(q)), int(np.ceil(q))
    w_hi = np.float32(q - np.float32(lo))
    w_lo = np.float32(np.float32(1.0) - w_hi)
    s = torch.sort(absr, dim=-1).values
    return s[..., lo] * float(w_lo) + s[..., hi] * float(w_hi)


def _nearest(moved, dst_masked, d2_dst):
    """Index and squared distance of each moved point's nearest
    destination point: first index of the row minimum of |m|^2 + |d|^2 -
    2 m.d."""
    m2 = (moved * moved).sum(-1, keepdim=True)
    d2 = torch.baddbmm(m2 + d2_dst[:, None, :], moved, dst_masked.transpose(1, 2), alpha=-2.0)
    d2min, j = torch.min(d2, dim=-1)
    return j, d2min


def _corr_sq(max_corr_dist: float, k: int) -> float:
    """The annealed correspondence radius of iteration k, squared, as the
    JAX package computes it in float32: max(r, 4 r 0.7^k)."""
    r = np.float32(max_corr_dist)
    corr = np.maximum(r, np.float32(4.0 * max_corr_dist) * np.float32(0.7) ** np.float32(k))
    return float(np.float32(corr * corr))


def _gather(x, j):
    return torch.gather(x, 1, j[..., None].expand(-1, -1, x.shape[-1]))


def _gn_update(T, T0, H, b, prior_weight: float):
    """Damped Gauss-Newton step with the seed prior and the trust region
    (0.05 m, 0.1 rad), applied on the left."""
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    r_prior = se3.log_se3(T @ se3.inv(T0))
    H = H + (prior_weight + 1e-6) * eye6
    b = b + prior_weight * r_prior
    delta = -_solve6(H, b)
    tn = torch.linalg.norm(delta[:, :3], dim=-1)
    rn = torch.linalg.norm(delta[:, 3:], dim=-1)
    one = torch.ones_like(tn)
    scale = torch.minimum(torch.where(tn > 0.05, 0.05 / tn, one),
                          torch.where(rn > 0.1, 0.1 / rn, one))
    return se3.exp_se3(delta * scale[:, None]) @ T


def _unconverged(T0):
    """The (rmse, n_pairs, converged) of a batch before any iteration."""
    B, dev = T0.shape[0], T0.device
    return (torch.full((B,), float("inf"), device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev))


def _finish(T, T_new, w, r2, ok, min_pairs: int):
    n_ok = ok.sum(-1, dtype=torch.int32)
    rmse = torch.sqrt((w * r2).sum(-1) / torch.clamp(n_ok, min=1))
    enough = n_ok >= min_pairs
    return torch.where(enough[:, None, None], T_new, T), rmse, n_ok, enough


def icp_point_to_plane(T0, src_points, src_valid, dst_points, dst_valid,
                       iterations: int = 10, max_corr_dist: float = 0.05,
                       src_stride: int = 4, dst_stride: int = 2,
                       prior_weight: float = 10.0, min_pairs: int = 50) -> IcpResult:
    """Refine T0 (B, 4, 4) (dst_T_src) by point-to-plane ICP between B
    pairs of (B, H, W, 3) grids and (B, H, W) masks (src every
    src_stride-th point, dst every dst_stride-th): annealed
    correspondence gate, Cauchy weights scaled by the residuals' 80th
    percentile, a weak prior towards the seed, and an update kept only
    with at least min_pairs correspondences."""
    src, sv = _subsample(src_points, src_valid, src_stride)
    dst, dv = _subsample(dst_points, dst_valid, dst_stride)
    nrm, _ = _subsample(grid_normals(dst_points, dst_valid), dst_valid, dst_stride)
    dst_masked = torch.where(dv[..., None], dst, 1e6)
    d2_dst = (dst_masked * dst_masked).sum(-1)
    T = T0
    rmse, n_ok, enough = _unconverged(T0)
    for k in range(iterations):
        moved = se3.apply(T, src)
        j, d2 = _nearest(moved, dst_masked, d2_dst)
        q, n = _gather(dst, j), _gather(nrm, j)
        ok = sv & (d2 < _corr_sq(max_corr_dist, k)) & (torch.linalg.norm(n, dim=-1) > 0.5)
        r = ((moved - q) * n).sum(-1)
        sigma = torch.clamp(_percentile80(torch.where(ok, r.abs(), 0.0)), min=0.003)
        w = ok.float() / (1.0 + (r / sigma[:, None]) ** 2)
        J = torch.cat([n, torch.linalg.cross(moved, n)], dim=-1)  # (B, N, 6)
        Jw = J * w[..., None]
        H = Jw.transpose(1, 2) @ J
        b = (Jw.transpose(1, 2) @ r[..., None])[..., 0]
        T_new = _gn_update(T, T0, H, b, prior_weight)
        T, rmse, n_ok, enough = _finish(T, T_new, w, r * r, ok, min_pairs)
    return IcpResult(T, rmse, n_ok, enough)


def icp_plane_to_plane(T0, src_points, src_valid, dst_points, dst_valid,
                       iterations: int = 10, max_corr_dist: float = 0.05,
                       src_stride: int = 4, dst_stride: int = 2,
                       prior_weight: float = 10.0, gicp_epsilon: float = 1e-3,
                       gicp_in_plane: float = 250.0, min_pairs: int = 50) -> IcpResult:
    """Plane-to-plane Generalized ICP: each point carries a disk covariance
    with eigenvalues (eps, kappa, kappa) about its grid normal (isotropic
    kappa where the source normal is undefined), each pair is scored by
    d^T (C_dst + R C_src R^T)^-1 d, and Gauss-Newton runs with that metric
    frozen per iteration; otherwise (shapes included) as
    icp_point_to_plane."""
    src, sv = _subsample(src_points, src_valid, src_stride)
    dst, dv = _subsample(dst_points, dst_valid, dst_stride)
    src_nrm, _ = _subsample(grid_normals(src_points, src_valid), src_valid, src_stride)
    dst_nrm, _ = _subsample(grid_normals(dst_points, dst_valid), dst_valid, dst_stride)
    dst_masked = torch.where(dv[..., None], dst, 1e6)
    d2_dst = (dst_masked * dst_masked).sum(-1)
    eye3 = torch.eye(3, device=T0.device)
    ca = torch.where(torch.linalg.norm(src_nrm, dim=-1) > 0.5, gicp_in_plane - gicp_epsilon, 0.0)
    B, N = sv.shape
    T = T0
    rmse, n_ok, enough = _unconverged(T0)
    for k in range(iterations):
        R = T[:, :3, :3]
        moved = se3.apply(T, src)
        j, d2 = _nearest(moved, dst_masked, d2_dst)
        q, nb = _gather(dst, j), _gather(dst_nrm, j)
        ok = sv & (d2 < _corr_sq(max_corr_dist, k)) & (torch.linalg.norm(nb, dim=-1) > 0.5)
        ma = src_nrm @ R.transpose(1, 2)
        C = (2.0 * gicp_in_plane * eye3
             - (gicp_in_plane - gicp_epsilon) * nb[..., :, None] * nb[..., None, :]
             - ca[..., None, None] * ma[..., :, None] * ma[..., None, :])
        M = _inv3x3_sym(C)  # (B, N, 3, 3)
        d = moved - q
        Md = (M @ d[..., None])[..., 0]
        r2 = (d * Md).sum(-1)
        sigma = torch.clamp(_percentile80(torch.where(ok, torch.sqrt(r2), 0.0)), min=0.003)
        w = ok.float() / (1.0 + r2 / (sigma * sigma)[:, None])
        J = torch.cat([eye3.expand(B, N, 3, 3), -se3.hat(moved)], dim=-1)  # (B, N, 3, 6)
        WJ = (J * w[..., None, None]).reshape(B, N * 3, 6).transpose(1, 2)
        H = WJ @ (M @ J).reshape(B, N * 3, 6)
        b = (WJ @ Md.reshape(B, N * 3, 1))[..., 0]
        T_new = _gn_update(T, T0, H, b, prior_weight)
        T, rmse, n_ok, enough = _finish(T, T_new, w, r2, ok, min_pairs)
    return IcpResult(T, rmse, n_ok, enough)
