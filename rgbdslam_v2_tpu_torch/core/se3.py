"""SE(3) / SO(3) geometry on torch tensors: batched, closed form.

Port of ``rgbdslam_v2_tpu/core/se3.py`` (hat, exp/log maps, quaternion
conversions, inv/relative/apply, rotation_angle, translation_norm). Poses are homogeneous (..., 4, 4) float32 matrices;
twists are ``xi = [v, w]`` (translation first).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sinc(x):
    small = x.abs() < 1e-5
    return torch.where(small, 1.0 - x * x / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def _cosc(x):
    x2 = x * x
    small = x.abs() < 1e-4
    return torch.where(small, 0.5 - x2 / 24.0,
                       (1.0 - torch.cos(x)) / torch.where(small, torch.ones_like(x), x2))


def _eye(n, like: torch.Tensor, batch) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(*batch, n, n)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w, dim=-1)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye(3, w, W.shape[:-2]) + a * W + b * W2


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    xyz, qw = q[..., :3], q[..., 3]
    sign = torch.where(qw < 0, -1.0, 1.0)
    xyz = xyz * sign[..., None]
    qw = qw * sign
    sn = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(sn, qw)
    small = sn < _EPS
    scale = torch.where(small, 2.0, theta / torch.where(small, torch.ones_like(sn), sn))
    return xyz * scale[..., None]


def log_so3(R: torch.Tensor) -> torch.Tensor:
    return quat_to_axis_angle(rot_to_quat(R))


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.norm(w, dim=-1)
    W = hat(w)
    W2 = W @ W
    R = exp_so3(w)
    b = _cosc(theta)
    th2 = theta * theta
    small = theta < 1e-4
    c = torch.where(
        small,
        1.0 / 6.0 - th2 / 120.0,
        (theta - torch.sin(theta)) / torch.where(small, torch.ones_like(theta), th2 * theta),
    )
    V = _eye(3, xi, R.shape[:-2]) + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return from_rt(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6) [v, w]."""
    R, t = to_rt(T)
    w = log_so3(R)
    theta = torch.linalg.norm(w, dim=-1)
    W = hat(w)
    W2 = W @ W
    th2 = theta * theta
    small = theta < 1e-4
    safe_th2 = torch.where(small, torch.ones_like(th2), th2)
    safe_den = torch.where(small, torch.ones_like(theta), 2.0 * theta * torch.sin(theta))
    coef = torch.where(
        small,
        1.0 / 12.0 + th2 / 720.0,
        1.0 / safe_th2 - (1.0 + torch.cos(theta)) / safe_den,
    )
    Vinv = _eye(3, T, R.shape[:-2]) - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    out = F.pad(torch.cat([R, t[..., None]], dim=-1), (0, 0, 0, 1))
    # fill_, not item assignment: assigning a Python number to the 0-dim
    # view of a single pose copies it from the host, which waits for the card
    out[..., 3, 3].fill_(1.0)
    return out


def to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def inv(T: torch.Tensor) -> torch.Tensor:
    R, t = to_rt(T)
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def relative(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^{-1} B: the motion taking frame A to frame B."""
    return inv(A) @ B


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude (radians) of (..., 4, 4) or (..., 3, 3)."""
    tr = T[..., 0, 0] + T[..., 1, 1] + T[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(T[..., :3, 3], dim=-1)


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4), pts (..., N, 3) -> (..., N, 3)."""
    R, t = to_rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rot_to_quat(R: torch.Tensor, norm=None) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), w >= 0 (Shepperd),
    normalized by `norm` (torch.linalg.norm by default)."""
    norm = norm or (lambda q: torch.linalg.norm(q, dim=-1, keepdim=True))
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw_w = piv(1.0 + tr)
    q_w = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw_w * qw_w], -1) / (
        4.0 * qw_w[..., None])
    qx_x = piv(1.0 + m00 - m11 - m22)
    q_x = torch.stack([4.0 * qx_x * qx_x, m01 + m10, m02 + m20, m21 - m12], -1) / (
        4.0 * qx_x[..., None])
    qy_y = piv(1.0 - m00 + m11 - m22)
    q_y = torch.stack([m01 + m10, 4.0 * qy_y * qy_y, m12 + m21, m02 - m20], -1) / (
        4.0 * qy_y[..., None])
    qz_z = piv(1.0 - m00 - m11 + m22)
    q_z = torch.stack([m02 + m20, m12 + m21, 4.0 * qz_z * qz_z, m10 - m01], -1) / (
        4.0 * qz_z[..., None])
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # (..., 4, 4)
    q = torch.gather(qs, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / norm(q)
    sign = torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return q * sign


def norm_fma(x: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis (kept) as the JAX package's
    float32 ``jnp.linalg.norm`` rounds on the CPU: XLA accumulates the
    squares in order with fused multiply-adds. Each float32 square is exact
    in float64, so a float64 accumulation rounded to float32 a step gives the
    fused result (but for a double rounding, 1 in ~2^29)."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        xk = x[..., k].double()
        acc = (acc.double() + xk * xk).float()
    return torch.sqrt(acc)[..., None]


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (x, y, z, w) -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def tum_to_pose(t: torch.Tensor, q_xyzw: torch.Tensor) -> torch.Tensor:
    """Translation (..., 3) and quaternion xyzw (..., 4) -> (..., 4, 4)."""
    return from_rt(quat_to_rot(q_xyzw), t)


def pose_to_tum(T: torch.Tensor):
    """(..., 4, 4) -> ((..., 3) translation, (..., 4) quaternion xyzw); the
    quaternion normalized by norm_fma, so the trajectory and g2o files the
    port writes hold the JAX package's digits."""
    R, t = to_rt(T)
    return t, rot_to_quat(R, norm_fma)

