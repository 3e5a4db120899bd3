"""SE(3) in float64 NumPy: the exponential and logarithm of twists [v, w]
(translation first), inverses and the adjoint, written from the closed
forms."""
from __future__ import annotations

import numpy as np


def hat(w: np.ndarray) -> np.ndarray:
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def inv(T: np.ndarray) -> np.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros_like(T)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def _coefs(theta: np.ndarray):
    """sin(x)/x, (1 - cos x)/x^2, (x - sin x)/x^3, with their series near 0."""
    small = theta < 1e-4
    th = np.where(small, 1.0, theta)
    a = np.where(small, 1.0 - theta**2 / 6.0, np.sin(th) / th)
    b = np.where(small, 0.5 - theta**2 / 24.0, (1.0 - np.cos(th)) / th**2)
    c = np.where(small, 1.0 / 6.0 - theta**2 / 120.0, (th - np.sin(th)) / th**3)
    return a, b, c


def exp(xi: np.ndarray) -> np.ndarray:
    """(..., 6) [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta = np.linalg.norm(w, axis=-1)
    W = hat(w)
    W2 = W @ W
    a, b, c = (x[..., None, None] for x in _coefs(theta))
    eye = np.eye(3)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    out = np.zeros((*xi.shape[:-1], 4, 4))
    out[..., :3, :3] = R
    out[..., :3, 3] = (V @ v[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def log_so3(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> axis-angle (..., 3), theta in [0, pi]."""
    cos = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos)
    vee = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                    R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < 1e-6
    s = np.where(small, 1.0, np.sin(theta))
    w = np.where(small[..., None], 0.5 * vee, vee * (theta / (2.0 * s))[..., None])
    near_pi = theta > np.pi - 1e-4
    if np.any(near_pi):  # the axis from the symmetric part
        for idx in zip(*np.nonzero(near_pi)) if near_pi.ndim else [()]:
            Rk = R[idx]
            B = (Rk + np.eye(3)) * 0.5
            k = int(np.argmax(np.diag(B)))
            axis = B[:, k] / np.sqrt(max(B[k, k], 1e-30))
            if np.dot(axis, vee[idx]) < 0:
                axis = -axis
            w[idx] = axis / np.linalg.norm(axis) * theta[idx]
    return w


def log(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> twist (..., 6) [v, w]."""
    w = log_so3(T[..., :3, :3])
    theta = np.linalg.norm(w, axis=-1)
    W = hat(w)
    small = theta < 1e-4
    th = np.where(small, 1.0, theta)
    coef = np.where(small, 1.0 / 12.0 + theta**2 / 720.0,
                    1.0 / th**2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th)))
    Vinv = np.eye(3) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ T[..., :3, 3][..., None])[..., 0]
    return np.concatenate([v, w], -1)


def adjoint(T: np.ndarray) -> np.ndarray:
    """(..., 6, 6) adjoint for twists [v, w]: [[R, hat(t) R], [0, R]]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros((*T.shape[:-2], 6, 6))
    out[..., :3, :3] = R
    out[..., :3, 3:] = hat(t) @ R
    out[..., 3:, 3:] = R
    return out


def apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """T (..., 4, 4), pts (..., N, 3) -> (..., N, 3)."""
    return pts @ np.swapaxes(T[..., :3, :3], -1, -2) + T[..., None, :3, 3]
