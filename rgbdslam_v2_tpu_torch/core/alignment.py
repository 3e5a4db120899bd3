"""Weighted rigid alignment from 3D correspondences, closed form.

Port of ``rgbdslam_v2_tpu/core/alignment.py``: ``weighted_kabsch`` (SVD),
``weighted_kabsch_quat`` (Horn's quaternion by shifted power iteration, the
RANSAC hypothesis fit) and ``horn_align_trajectories``.

``weighted_kabsch`` takes CPU tensors through its plain version
``weighted_kabsch_plain`` (``torch.linalg.svd`` + ``det``) and CUDA tensors
through the hand-written kernel ``csrc/kabsch.cu`` (one launch a call, a
3x3 SVD in registers): cuSOLVER's SVD and det wait for the card to check
their status, the kernel does not, so the per-frame step holds no host
sync and can be captured as a CUDA graph. ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import backend
from . import se3

LAUNCHES = 0  # kernel launches (incremented only where the kernel launches)
_fn = None

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


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = backend.load_kernel_library("kabsch").weighted_kabsch_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def weighted_kabsch_cuda(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel: one launch for every problem of the batch."""
    global LAUNCHES
    n = src.shape[-2]
    if not (src.is_cuda and dst.device == src.device and w.device == src.device):
        raise ValueError("weighted_kabsch_cuda needs CUDA tensors on one device")
    if (src.dtype, dst.dtype, w.dtype) != (torch.float32,) * 3:
        raise ValueError("weighted_kabsch_cuda takes float32 tensors")
    if src.shape[-1] != 3 or dst.shape != src.shape or w.shape != src.shape[:-1]:
        raise ValueError(f"shapes src {tuple(src.shape)}, dst {tuple(dst.shape)}, "
                         f"w {tuple(w.shape)}: expected (..., N, 3) twice and (..., N)")
    batch = src.shape[:-2]
    s = src.reshape(-1, n, 3).contiguous()
    d = dst.reshape(-1, n, 3).contiguous()
    ww = w.reshape(-1, n).contiguous()
    out = torch.empty((s.shape[0], 4, 4), dtype=torch.float32, device=src.device)
    if s.shape[0] == 0:
        return out.reshape(*batch, 4, 4)
    status = _kernel_fn()(s.data_ptr(), d.data_ptr(), ww.data_ptr(), out.data_ptr(),
                          s.shape[0], n, torch.cuda.current_stream(src.device).cuda_stream)
    backend.check_launch(status, "weighted_kabsch_f32")
    LAUNCHES += 1
    return out.reshape(*batch, 4, 4)


def weighted_kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Best-fit T with dst ~ T @ src (weights w >= 0). src, dst (..., N, 3).
    CPU tensors -> plain version; CUDA -> the kernel."""
    if src.is_cuda:
        return weighted_kabsch_cuda(src, dst, w)
    return weighted_kabsch_plain(src, dst, w)


def weighted_kabsch_plain(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: torch.linalg.svd + det."""
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
