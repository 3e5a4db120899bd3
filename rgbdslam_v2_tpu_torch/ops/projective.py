"""Projective two-view pose refinement over (u, v, depth) measurements.

Port of ``rgbdslam_v2_tpu/ops/projective.py`` (``_proj_residual_jac``,
``refine_projective``, ``uvz_from_xyz``), batched over a leading candidate
dimension B where the JAX version is vmapped. The reference's
g2o_transformation_refinement (getTransformFromMatchesG2O,
transformation_estimation.cpp:37-170): each matched feature is a landmark
seen by both cameras through (u, v, z) measurements with information
diag(1, 1, 1/sigma_z^2), sigma_z = sigma_depth * max(z, 0.3)^2; the newer
camera is fixed and Gauss-Newton alternates a 3x3 step per landmark with
one 6x6 step of the candidate camera's pose.

This is the plain torch version. On the card the stage runs inside the
RANSAC refine kernel (``csrc/kabsch.cu``, ``ransac_refine_f32`` with
``projective_iterations > 0``); ``ops/registration.ransac_refine_plain``
calls this function. Its solves are ``torch.linalg.solve_ex`` with
``check_errors=False``: the plain ``solve`` reads its status on the host.
"""
from __future__ import annotations

import torch

from ..core import se3


def _proj_residual_jac(q, meas_uvz, fx, fy, cx, cy):
    """q (..., 3) camera-frame points, meas_uvz (..., 3) -> residual r (...,
    3) = (u(q) - u, v(q) - v, qz - z) and J (..., 3, 3) = dr/dq."""
    qz = torch.where(q[..., 2].abs() < 1e-6, torch.full_like(q[..., 2], 1e-6), q[..., 2])
    u = fx * q[..., 0] / qz + cx
    v = fy * q[..., 1] / qz + cy
    r = torch.stack([u - meas_uvz[..., 0], v - meas_uvz[..., 1], q[..., 2] - meas_uvz[..., 2]],
                    dim=-1)
    z0 = torch.zeros_like(qz)
    J = torch.stack([
        torch.stack([fx / qz, z0, -fx * q[..., 0] / (qz * qz)], dim=-1),
        torch.stack([z0, fy / qz, -fy * q[..., 1] / (qz * qz)], dim=-1),
        torch.stack([z0, z0, torch.ones_like(qz)], dim=-1),
    ], dim=-2)
    return r, J


def _info3(z, sigma_depth):
    """(..., M) measured depth -> (..., M, 3) diag(1, 1, 1/sigma_z^2)."""
    sz = sigma_depth * torch.clamp(z, min=0.3) ** 2
    one = torch.ones_like(z)
    return torch.stack([one, one, 1.0 / (sz * sz)], dim=-1)


def refine_projective(T0: torch.Tensor, src_uvz: torch.Tensor, dst_uvz: torch.Tensor,
                      weights: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
                      iterations: int = 4, sigma_depth: float = 0.01,
                      damping: float = 1e-6) -> torch.Tensor:
    """T0 (B, 4, 4) cand_T_new, (B, M, 3) (u, v, z) of the NEW and the
    CAND frame, (B, M) weights (0 drops a match) -> the refined (B, 4, 4).
    Landmarks live in the new camera's frame; only the candidate camera's
    residuals depend on the pose."""
    w = torch.clamp(weights, min=0.0)
    W_src = _info3(src_uvz[..., 2], sigma_depth) * w[..., None]
    W_dst = _info3(dst_uvz[..., 2], sigma_depth) * w[..., None]
    z = src_uvz[..., 2]
    p = torch.stack([(src_uvz[..., 0] - cx) * z / fx, (src_uvz[..., 1] - cy) * z / fy, z],
                    dim=-1)
    eye3 = torch.eye(3, dtype=T0.dtype, device=T0.device)
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    T = T0
    for _ in range(iterations):
        R, t = T[:, None, :3, :3], T[:, None, :3, 3]  # (B, 1, 3, 3), (B, 1, 3)

        # (a) one 3x3 GN step per landmark
        r_s, J_s = _proj_residual_jac(p, src_uvz, fx, fy, cx, cy)
        q = (R @ p[..., None])[..., 0] + t
        r_d, J_dq = _proj_residual_jac(q, dst_uvz, fx, fy, cx, cy)
        J_d = J_dq @ R
        H = (torch.einsum("bmki,bmk,bmkj->bmij", J_s, W_src, J_s)
             + torch.einsum("bmki,bmk,bmkj->bmij", J_d, W_dst, J_d) + damping * eye3)
        b = (torch.einsum("bmki,bmk,bmk->bmi", J_s, W_src, r_s)
             + torch.einsum("bmki,bmk,bmk->bmi", J_d, W_dst, r_d))
        p = p - torch.linalg.solve_ex(H, b[..., None], check_errors=False).result[..., 0]

        # (b) the 6x6 pose step over the candidate camera's residuals
        q = (R @ p[..., None])[..., 0] + t
        r_d, J_dq = _proj_residual_jac(q, dst_uvz, fx, fy, cx, cy)
        Jq_xi = torch.cat([eye3.expand(*q.shape[:-1], 3, 3), -se3.hat(q)], dim=-1)
        J6 = J_dq @ Jq_xi  # (B, M, 3, 6)
        H6 = torch.einsum("bmki,bmk,bmkj->bij", J6, W_dst, J6) + damping * eye6
        b6 = torch.einsum("bmki,bmk,bmk->bi", J6, W_dst, r_d)
        xi = -torch.linalg.solve_ex(H6, b6[..., None], check_errors=False).result[..., 0]
        # a degenerate system (few or collinear inliers) must not blow up
        ok = torch.isfinite(xi).all(dim=-1) & (torch.linalg.norm(xi, dim=-1) < 1.0)
        xi = torch.where(ok[:, None], xi, torch.zeros_like(xi))
        T = se3.exp_se3(xi) @ T
    return T


def uvz_from_xyz(xyz: torch.Tensor, fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """(..., 3) camera-frame points -> (u, v, z) measurements (the inverse
    of the keypoint backprojection)."""
    z = torch.where(xyz[..., 2].abs() < 1e-6, torch.full_like(xyz[..., 2], 1e-6), xyz[..., 2])
    return torch.stack([fx * xyz[..., 0] / z + cx, fy * xyz[..., 1] / z + cy, xyz[..., 2]],
                       dim=-1)
