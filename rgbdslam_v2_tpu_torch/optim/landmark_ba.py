"""Landmark bundle adjustment: feature points as variables beside the poses.

Port of ``rgbdslam_v2_tpu/optim/landmark_ba.py`` (``LandmarkGraph``,
``chi2``, ``optimize_landmarks``, ``make_landmark_graph``; the reference's
DO_FEATURE_OPTIMIZATION mode, src/landmark.{h,cpp},
src/graph_manager.cpp:137-143,188-200, its EdgeSE3PointXYZDepth
observations, src/transformation_estimation.cpp:91-124).

A fixed-capacity observation table and alternating Gauss-Newton: each
round first moves the landmarks with the poses held (intersection), then
the poses with the landmarks held (resection). Each half is a batch of
independent small solves: per-landmark 3x3 and per-pose 6x6 normal
equations summed over the observations with ``index_add_`` and solved with
``torch.linalg.solve_ex`` (no host synchronization).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import se3
from ..core.camera import Intrinsics
from ..core.noise import point_covariance_diag


@dataclasses.dataclass
class LandmarkGraph:
    """Fixed-capacity BA problem."""

    poses: torch.Tensor  # (N, 4, 4) world_T_cam
    pose_fixed: torch.Tensor  # (N,) bool
    landmarks: torch.Tensor  # (L, 3) world positions
    lm_active: torch.Tensor  # (L,) bool
    obs_lm: torch.Tensor  # (O,) int64 landmark index
    obs_pose: torch.Tensor  # (O,) int64 pose index
    obs_uvz: torch.Tensor  # (O, 3) measured (u, v, depth)
    obs_active: torch.Tensor  # (O,) bool

    def replace(self, **kw) -> "LandmarkGraph":
        return dataclasses.replace(self, **kw)


def _project(g: LandmarkGraph):
    """cam_T_world of each observation and the landmark in its camera."""
    Tcw = se3.inv(g.poses[g.obs_pose])
    return Tcw, se3.apply(Tcw, g.landmarks[g.obs_lm][:, None, :])[:, 0, :]


def _residuals(g: LandmarkGraph, cam: Intrinsics, sigma_depth: float):
    """Per-observation residual r = (u_pred - u, v_pred - v, z_pred - z) and
    the diagonal information weights (1 px^2 laterally, the depth variance
    of the noise model: the EdgeSE3PointXYZDepth measurement model)."""
    _, p_cam = _project(g)
    z = torch.clamp(p_cam[:, 2], min=1e-6)
    u = p_cam[:, 0] / z * cam.fx + cam.cx
    v = p_cam[:, 1] / z * cam.fy + cam.cy
    r = torch.stack([u - g.obs_uvz[:, 0], v - g.obs_uvz[:, 1], p_cam[:, 2] - g.obs_uvz[:, 2]],
                    dim=-1)
    z_meas = torch.clamp(g.obs_uvz[:, 2], min=0.1)
    var_z = point_covariance_diag(z_meas, cam.fx, cam.fy, sigma_depth)[:, 2]
    one = torch.ones_like(var_z)
    w = torch.stack([one, one, 1.0 / var_z], dim=-1) * g.obs_active[:, None]
    return r, w, p_cam


def chi2(g: LandmarkGraph, cam: Intrinsics, sigma_depth: float = 0.01) -> torch.Tensor:
    r, w, _ = _residuals(g, cam, sigma_depth)
    return torch.sum(r * r * w)


def _jac_proj(p_cam: torch.Tensor, cam: Intrinsics) -> torch.Tensor:
    """d(u, v, z) / d p_cam: (O, 3, 3)."""
    z = torch.clamp(p_cam[:, 2], min=1e-6)
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    return torch.stack([
        torch.stack([cam.fx / z, zero, -cam.fx * p_cam[:, 0] / (z * z)], -1),
        torch.stack([zero, cam.fy / z, -cam.fy * p_cam[:, 1] / (z * z)], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def _normal_equations(J, w, r, index, n: int):
    """Per-variable (n, d, d) and (n, d) sums of J^T W J and J^T W r over the
    observations (index: each observation's variable)."""
    JTw = J * w[:, :, None]
    H = torch.einsum("oki,okj->oij", JTw, J)
    b = torch.einsum("oki,ok->oi", JTw, r)
    d = J.shape[-1]
    Hs = torch.zeros((n, d, d), dtype=J.dtype, device=J.device).index_add_(0, index, H)
    bs = torch.zeros((n, d), dtype=J.dtype, device=J.device).index_add_(0, index, b)
    return Hs, bs


@torch.inference_mode()
def optimize_landmarks(g: LandmarkGraph, cam: Intrinsics, iterations: int = 5,
                       sigma_depth: float = 0.01) -> LandmarkGraph:
    """Alternating BA: landmark intersection, then pose resection, a round."""
    L, N = g.landmarks.shape[0], g.poses.shape[0]
    dev = g.poses.device
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    free = ~g.pose_fixed
    for _ in range(iterations):
        # intersection: the landmarks move, the poses are held
        r, w, _ = _residuals(g, cam, sigma_depth)
        Tcw, p_cam = _project(g)
        Hl, bl = _normal_equations(_jac_proj(p_cam, cam) @ Tcw[:, :3, :3], w, r, g.obs_lm, L)
        delta = -torch.linalg.solve_ex(Hl + eye3 * 1e-4, bl[..., None],
                                       check_errors=False).result[..., 0]
        ok = g.lm_active & (torch.linalg.norm(delta, dim=-1) < 1.0)
        g = g.replace(landmarks=g.landmarks + torch.where(ok[:, None], delta, 0.0))
        # resection: the poses move (world_T_cam <- world_T_cam @ exp(xi)),
        # the landmarks are held; cam_T_world <- exp(-xi) cam_T_world gives
        # dp_cam / dxi = [-I | hat(p_cam)]
        r, w, _ = _residuals(g, cam, sigma_depth)
        _, p_cam = _project(g)
        Jx = torch.cat([-eye3.expand(r.shape[0], 3, 3), se3.hat(p_cam)], dim=-1)
        Hp, bp = _normal_equations(_jac_proj(p_cam, cam) @ Jx, w, r, g.obs_pose, N)
        Hp = Hp + eye6 * 1e-3 + g.pose_fixed[:, None, None] * eye6
        delta = -torch.linalg.solve_ex(Hp, bp[..., None], check_errors=False).result[..., 0]
        g = g.replace(poses=g.poses @ se3.exp_se3(delta * free[:, None]))
    return g


def make_landmark_graph(n_poses: int, n_landmarks: int, n_obs: int, device=None) -> LandmarkGraph:
    kw = dict(device=device)
    return LandmarkGraph(
        poses=torch.eye(4, **kw).repeat(n_poses, 1, 1),
        pose_fixed=torch.zeros(n_poses, dtype=torch.bool, **kw),
        landmarks=torch.zeros((n_landmarks, 3), **kw),
        lm_active=torch.zeros(n_landmarks, dtype=torch.bool, **kw),
        obs_lm=torch.zeros(n_obs, dtype=torch.long, **kw),
        obs_pose=torch.zeros(n_obs, dtype=torch.long, **kw),
        obs_uvz=torch.zeros((n_obs, 3), **kw),
        obs_active=torch.zeros(n_obs, dtype=torch.bool, **kw),
    )
