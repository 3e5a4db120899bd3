"""Pairwise 6-DoF registration: batched RANSAC with Mahalanobis inliers.

Port of ``rgbdslam_v2_tpu/ops/registration.py`` (``_sym3_solve``,
``mahalanobis_sq``, ``_gumbel_topk_sample``, ``pose_information``,
``ransac_register`` with its projective refinement), batched over a
leading candidate dimension B where the JAX version is vmapped.

Hypothesis sampling draws Gumbel noise from a ``torch.Generator``; it cannot
reproduce ``jax.random``'s draws, so ``ransac_register`` takes an optional
``sample_idx`` that a parity test fills with the JAX indices.

The refinement after the hypothesis sweep (masked Kabsch refits, each gated
by the full-covariance Mahalanobis test; with ``projective_iterations > 0``
the projective refinement of ``ops/projective.py`` on the re-gated inliers,
kept where it loses no inlier; then the final score) is
``ransac_refine``: CPU tensors go to its plain version
``ransac_refine_plain``, CUDA tensors to the hand-written kernel
``ransac_refine_f32`` in ``csrc/kabsch.cu`` (one launch a call for every
candidate, refit and projective iteration, no host sync). ``LAUNCHES``
counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import backend
from ..core import se3
from ..core.alignment import weighted_kabsch_plain, weighted_kabsch_quat
from ..core.noise import point_covariance_diag
from .projective import refine_projective, uvz_from_xyz

LAUNCHES = 0  # ransac_refine kernel launches (incremented only where the kernel launches)
REFINE_MAX_MATCHES = 16384  # csrc/kabsch.cu: 256 threads x 64 inlier bits a thread
_fn = None


class RegistrationResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) dst_T_src
    inliers: torch.Tensor  # (B, M) bool
    n_inliers: torch.Tensor  # (B,) int32
    rmse: torch.Tensor  # (B,) float32
    success: torch.Tensor  # (B,) bool


class Projective(NamedTuple):
    """The projective stage of the refinement: its iterations (0: off), the
    full-resolution intrinsics and the depth noise of its information."""

    iterations: int = 0
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    sigma_depth: float = 0.01


NO_PROJECTIVE = Projective()


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


def pose_information(T, src_xyz, dst_xyz, src_cov, dst_cov, inliers) -> torch.Tensor:
    """(B, 6, 6) Gauss-Newton information of the pose estimates: H = sum
    over inliers of J^T Sigma^-1 J, J = [I | -[T s]_x] (left perturbation
    (t, omega)), Sigma = D_dst + R D_src R^T; symmetrised. Un-normalised:
    the step trace-matches it to the scalar information."""
    R = T[:, :3, :3]
    p = se3.apply(T, src_xyz)  # (B, M, 3)
    Rb = R[:, None]
    Sigma = (Rb * src_cov[..., None, :]) @ Rb.transpose(-1, -2) + torch.diag_embed(dst_cov)
    eye = torch.eye(3, dtype=Sigma.dtype, device=Sigma.device)
    Sinv = torch.stack([_sym3_solve(Sigma, e.expand_as(Sigma[..., 0])) for e in eye], dim=-1)
    Sinv = Sinv * inliers.to(src_xyz.dtype)[..., None, None]
    P = se3.hat(p)  # J = [I | -P]: tt = Sinv, tr = -Sinv P, rr = P^T Sinv P
    SP = Sinv @ P
    tt = Sinv.sum(dim=1)
    tr = -SP.sum(dim=1)
    rr = (P.transpose(-1, -2) @ SP).sum(dim=1)
    H = torch.cat([torch.cat([tt, tr], dim=-1),
                   torch.cat([tr.transpose(-1, -2), rr], dim=-1)], dim=-2)
    return 0.5 * (H + H.transpose(-1, -2))


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
    projective_iterations: int = 0,
    cam_cx: float = 319.5,
    cam_cy: float = 239.5,
) -> RegistrationResult:
    """Batched RANSAC over B candidates' matched point pairs; dst_T_src.
    The identity is scored as one extra hypothesis. projective_iterations
    > 0 runs the reference's g2o_transformation_refinement on the final
    inlier set (ops/projective.py)."""
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
    T, inliers, n_inl, rmse = ransac_refine(
        src_xyz, dst_xyz, w_depth, src_cov, dst_cov, match_valid, T_h[bsel, best],
        inl[bsel, best], refine_iterations, max_mahal_sq,
        Projective(projective_iterations, cam_fx, cam_fy, cam_cx, cam_cy, sigma_depth))
    return RegistrationResult(transform=T, inliers=inliers, n_inliers=n_inl,
                              rmse=rmse, success=n_inl >= min_inliers)


def ransac_refine(src_xyz, dst_xyz, w_depth, src_cov, dst_cov, match_valid, T, inliers,
                  refine_iterations: int, max_mahal_sq: float,
                  projective: Projective = NO_PROJECTIVE):
    """The refits, the projective stage and the final score of
    ransac_register: (T (B, 4, 4), inliers (B, M) bool, n_inliers (B,)
    int32, rmse (B,)). CPU tensors -> the plain version; CUDA -> the
    kernel."""
    args = (src_xyz, dst_xyz, w_depth, src_cov, dst_cov, match_valid, T, inliers,
            refine_iterations, max_mahal_sq, projective)
    if src_xyz.is_cuda:
        return ransac_refine_cuda(*args)
    return ransac_refine_plain(*args)


def ransac_refine_plain(src_xyz, dst_xyz, w_depth, src_cov, dst_cov, match_valid, T, inliers,
                        refine_iterations: int, max_mahal_sq: float,
                        projective: Projective = NO_PROJECTIVE):
    """The plain version: masked refits with the exact SVD fit
    (torch.linalg.svd + det) and the full covariance model, each kept only
    where it leaves at least 3 inliers; the projective stage where its
    iterations are > 0 (JAX ops/registration.py:280-305); then the final
    gate."""
    for _ in range(refine_iterations):
        w = torch.where(inliers, w_depth, 0.0)
        T2 = weighted_kabsch_plain(src_xyz, dst_xyz, w)
        m2 = mahalanobis_sq(T2, src_xyz, dst_xyz, src_cov, dst_cov)
        inl2 = match_valid & (m2 < max_mahal_sq)
        better = inl2.sum(dim=-1) >= 3
        T = torch.where(better[:, None, None], T2, T)
        inliers = torch.where(better[:, None], inl2, inliers)

    if projective.iterations > 0:
        pj = projective
        m2 = mahalanobis_sq(T, src_xyz, dst_xyz, src_cov, dst_cov)
        inliers = match_valid & (m2 < max_mahal_sq)
        T_p = refine_projective(
            T, uvz_from_xyz(src_xyz, pj.fx, pj.fy, pj.cx, pj.cy),
            uvz_from_xyz(dst_xyz, pj.fx, pj.fy, pj.cx, pj.cy), inliers.to(src_xyz.dtype),
            pj.fx, pj.fy, pj.cx, pj.cy, iterations=pj.iterations, sigma_depth=pj.sigma_depth)
        # kept only where it loses no inlier under the acceptance gate
        m2_p = mahalanobis_sq(T_p, src_xyz, dst_xyz, src_cov, dst_cov)
        inl_p = match_valid & (m2_p < max_mahal_sq)
        better = inl_p.sum(dim=-1) >= inliers.sum(dim=-1)
        T = torch.where(better[:, None, None], T_p, T)

    m2 = mahalanobis_sq(T, src_xyz, dst_xyz, src_cov, dst_cov)
    inliers = match_valid & (m2 < max_mahal_sq)
    n_inl = inliers.sum(dim=-1, dtype=torch.int32)
    rmse = torch.sqrt(torch.where(inliers, m2, 0.0).sum(dim=-1) / torch.clamp(n_inl, min=1))
    return T, inliers, n_inl, rmse


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = backend.load_kernel_library("kabsch").ransac_refine_f32
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_double]
                       + [ctypes.c_int] + [ctypes.c_double] * 5 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ransac_refine_cuda(src_xyz, dst_xyz, w_depth, src_cov, dst_cov, match_valid, T, inliers,
                       refine_iterations: int, max_mahal_sq: float,
                       projective: Projective = NO_PROJECTIVE):
    """The kernel: one launch for every candidate, refit and projective
    iteration. The projective stage keeps its landmarks in a float64
    scratch tensor of (B, M, 3), allocated here only where it runs."""
    global LAUNCHES
    pts = (src_xyz, dst_xyz, src_cov, dst_cov)
    if not src_xyz.is_cuda or any(x.device != src_xyz.device for x in
                                  (*pts, w_depth, match_valid, T, inliers)):
        raise ValueError("ransac_refine_cuda needs CUDA tensors on one device")
    if (any(x.dtype != torch.float32 for x in (*pts, w_depth, T))
            or match_valid.dtype != torch.bool or inliers.dtype != torch.bool):
        raise ValueError("ransac_refine_cuda takes float32 points, covariances, weights and "
                         "transforms and bool masks")
    B, M = match_valid.shape
    if (any(x.shape != (B, M, 3) for x in pts) or w_depth.shape != (B, M)
            or inliers.shape != (B, M) or T.shape != (B, 4, 4)):
        raise ValueError(f"shapes: expected (B, M, 3) points and covariances, (B, M) weights "
                         f"and masks, (B, 4, 4) T for B={B}, M={M}")
    pj = projective
    if M > REFINE_MAX_MATCHES or refine_iterations < 0 or pj.iterations < 0:
        raise ValueError(f"ransac_refine_cuda takes at most {REFINE_MAX_MATCHES} matches and "
                         f"refine_iterations, projective iterations >= 0 (got {M}, "
                         f"{refine_iterations}, {pj.iterations})")
    dev = src_xyz.device
    T_out = torch.empty((B, 4, 4), dtype=torch.float32, device=dev)
    inl_out = torch.empty((B, M), dtype=torch.bool, device=dev)
    n_out = torch.empty((B,), dtype=torch.int32, device=dev)
    rmse = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return T_out, inl_out, n_out, rmse
    ins = [x.contiguous() for x in (src_xyz, dst_xyz, w_depth, src_cov, dst_cov, match_valid,
                                    T, inliers)]
    landmarks = (torch.empty((B, M, 3), dtype=torch.float64, device=dev)
                 if pj.iterations > 0 else None)
    status = _kernel_fn()(*(x.data_ptr() for x in ins), T_out.data_ptr(), inl_out.data_ptr(),
                          n_out.data_ptr(), rmse.data_ptr(), B, M, int(refine_iterations),
                          float(max_mahal_sq), int(pj.iterations), float(pj.fx), float(pj.fy),
                          float(pj.cx), float(pj.cy), float(pj.sigma_depth),
                          None if landmarks is None else landmarks.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    backend.check_launch(status, "ransac_refine_f32")
    LAUNCHES += 1
    return T_out, inl_out, n_out, rmse
