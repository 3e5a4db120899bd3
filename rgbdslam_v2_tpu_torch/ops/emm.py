"""Environment Measurement Model: depth-reprojection validation.

Port of ``rgbdslam_v2_tpu/ops/emm.py`` (``emm_pool_maps``, ``emm_unpack``,
``observation_likelihood`` with the store-row lookup, the reference's
verbatim 9-sample ``observation_likelihood_exact`` of ``tpu_emm_exact``,
``pairwise_observation_likelihood``, ``rejection_significance`` and
``observation_criterion_met``), batched over a leading candidate
dimension.

The pool maps pack the 5x5 window min and max depth as float16 into one
32-bit word per pixel, ``lo | hi << 16``. Torch has little uint32 support,
so the word is an int32 with the same bits (``.view(uint32)`` in numpy
gives the JAX array).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core import se3
from ..core.camera import Intrinsics
from ..core.noise import depth_covariance


class EmmResult(NamedTuple):
    inliers: torch.Tensor  # (B,) int32
    outliers: torch.Tensor
    occluded: torch.Tensor
    all_projected: torch.Tensor
    quality: torch.Tensor  # (B,) float32


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float16 bit pattern in [0, 65535] as int32."""
    return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF


def emm_pool_maps(depth: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(..., H, W) depth -> (..., H, W) int32 packed [lo | hi << 16] f16
    pool maps (window min / max of the valid depths)."""
    shape = depth.shape
    d = depth.reshape(-1, 1, *shape[-2:])
    k = 2 * r + 1
    lo = -F.max_pool2d(torch.where(d > 0, -d, float("-inf")), k, stride=1, padding=r)
    hi = F.max_pool2d(torch.where(d > 0, d, float("-inf")), k, stride=1, padding=r)
    packed = _f16_bits(lo) | (_f16_bits(hi) << 16)
    return packed.reshape(shape)


def emm_unpack(packed: torch.Tensor):
    """int32 packed pools -> (lo, hi) float32."""
    lo = packed & 0xFFFF
    lo = lo - ((lo & 0x8000) << 1)  # sign-extend the low half
    hi = packed >> 16  # arithmetic shift sign-extends the high half
    as_f32 = lambda h: h.to(torch.int16).view(torch.float16).to(torch.float32)  # noqa: E731
    return as_f32(lo), as_f32(hi)


def observation_likelihood(
    old_T_new: torch.Tensor,  # (B, 4, 4)
    new_points: torch.Tensor,  # (B or 1, N, 3) new-frame camera points
    new_valid: torch.Tensor,  # (B or 1, N) bool
    cam: Intrinsics,
    old_lohi: torch.Tensor,  # (R, h*w) packed pool rows
    old_lohi_row: Optional[torch.Tensor] = None,  # (B,) row per candidate
    sigma_depth: float = 0.01,
    gate_sigmas: float = 2.5,
) -> EmmResult:
    """Project new points into the old camera; classify each against the
    old frame's pooled [min, max] depth window as inlier / occluded /
    outlier within gate_sigmas * sigma(z)."""
    B = old_T_new.shape[0]
    z_pred, in_img, ui, vi = _project(old_T_new, new_points, new_valid, cam)
    pix = vi * cam.width + ui
    if old_lohi_row is None:
        old_lohi_row = torch.zeros(B, dtype=torch.long, device=old_T_new.device)
    packed = old_lohi[old_lohi_row[:, None], pix]
    lo, hi = emm_unpack(packed)
    has_obs = torch.isfinite(lo)
    best_obs = torch.where(has_obs, torch.minimum(torch.maximum(z_pred, lo), hi), 0.0)
    counted = in_img & has_obs
    sigma2 = depth_covariance(z_pred, sigma_depth) + depth_covariance(best_obs, sigma_depth)
    gate = gate_sigmas * torch.sqrt(sigma2)
    diff = best_obs - z_pred
    return _counts(counted & (diff.abs() <= gate), counted & (diff > gate),
                   counted & (diff < -gate), counted)


def _project(old_T_new, pts, val, cam: Intrinsics):
    """Move (B|1, N, 3) points into the old camera: (z_pred, in_img, ui,
    vi), each (B, N)."""
    moved = se3.apply(old_T_new, pts)
    z_pred = moved[..., 2]
    safe_z = torch.where(z_pred.abs() < 1e-6, torch.full_like(z_pred, 1e-6), z_pred)
    u = moved[..., 0] / safe_z * cam.fx + cam.cx
    v = moved[..., 1] / safe_z * cam.fy + cam.cy
    in_img = (val & (z_pred > 0.1) & (u >= 1.0) & (u <= cam.width - 2.0)
              & (v >= 1.0) & (v <= cam.height - 2.0))
    ui = torch.clamp(torch.round(u).long(), 0, cam.width - 1)
    vi = torch.clamp(torch.round(v).long(), 0, cam.height - 1)
    return z_pred, in_img, ui, vi


def _strided(points, valid, skip_step: int):
    """(B|1, H, W, 3) grid and (B|1, H, W) mask at stride skip_step ->
    (B|1, N, 3), (B|1, N)."""
    pts = points[..., ::skip_step, ::skip_step, :]
    val = valid[..., ::skip_step, ::skip_step]
    return pts.reshape(pts.shape[0], -1, 3), val.reshape(val.shape[0], -1)


def _counts(is_inlier, is_outlier, is_occluded, counted) -> EmmResult:
    n_in = is_inlier.sum(dim=-1, dtype=torch.int32)
    n_out = is_outlier.sum(dim=-1, dtype=torch.int32)
    n_occ = is_occluded.sum(dim=-1, dtype=torch.int32)
    n_all = counted.sum(dim=-1, dtype=torch.int32)
    quality = n_in.float() / torch.clamp(n_in + n_out, min=1).float()
    return EmmResult(n_in, n_out, n_occ, n_all, quality)


def observation_likelihood_exact(
    old_T_new: torch.Tensor,  # (B, 4, 4)
    new_points: torch.Tensor,  # (B or 1, H, W, 3) new-frame point grid
    new_valid: torch.Tensor,  # (B or 1, H, W) bool
    old_depth: torch.Tensor,  # (B or 1, H, W) old-frame depth, 0 where invalid
    cam: Intrinsics,
    skip_step: int = 2,
    sigma_depth: float = 0.01,
    gate_sigmas: float = 3.09,
    cov_scale: float = 1.0,
) -> EmmResult:
    """The reference's 9-sample neighbourhood EMM verbatim (misc.cpp:889-929):
    the 5x5 window at stride 2 around the projected pixel; inlier if ANY
    sample explains z_pred within gate_sigmas (3.09: the cdf test in
    (0.001, 0.999)), else occluded if ANY lies in front, else outlier if
    ANY lies behind. cov_scale inflates both variances by the cloud stride
    (misc.cpp:903-905)."""
    pts, val = _strided(new_points, new_valid, skip_step)
    z_pred, in_img, ui, vi = _project(old_T_new, pts, val, cam)
    B = z_pred.shape[0]
    flat = old_depth.reshape(old_depth.shape[0], -1)
    if flat.shape[0] != B:
        flat = flat.expand(B, -1)
    any_good = torch.zeros_like(in_img)
    any_front = torch.zeros_like(in_img)
    any_behind = torch.zeros_like(in_img)
    any_obs = torch.zeros_like(in_img)
    sig_new = cov_scale * depth_covariance(z_pred, sigma_depth)
    for dv in (-2, 0, 2):
        for du in (-2, 0, 2):
            uu = torch.clamp(ui + du, 0, cam.width - 1)
            vv = torch.clamp(vi + dv, 0, cam.height - 1)
            z_obs = torch.gather(flat, 1, vv * cam.width + uu)
            ok = z_obs > 0
            gate = gate_sigmas * torch.sqrt(
                sig_new + cov_scale * depth_covariance(z_obs, sigma_depth))
            diff = z_obs - z_pred
            any_good |= ok & (diff.abs() <= gate)
            any_front |= ok & (diff < -gate)
            any_behind |= ok & (diff > gate)
            any_obs |= ok
    counted = in_img & any_obs
    return _counts(counted & any_good, counted & ~any_good & ~any_front & any_behind,
                   counted & ~any_good & any_front, counted)


def observation_likelihood_dense(old_T_new, new_points, new_valid, old_depth, cam: Intrinsics,
                                 skip_step: int = 2, sigma_depth: float = 0.01) -> EmmResult:
    """The pooled EMM on a (B|1, H, W, 3) point grid at stride skip_step
    against (B, H, W) old depth maps (JAX observation_likelihood without
    precomputed pools)."""
    pts, val = _strided(new_points, new_valid, skip_step)
    B = old_T_new.shape[0]
    lohi = emm_pool_maps(old_depth).reshape(old_depth.shape[0], -1)
    rows = (torch.arange(B, device=lohi.device) if lohi.shape[0] == B
            else torch.zeros(B, dtype=torch.long, device=lohi.device))
    return observation_likelihood(old_T_new, pts, val, cam, lohi, rows, sigma_depth=sigma_depth)


def pairwise_observation_likelihood(new_T_old, new_points, new_valid, new_depth, old_points,
                                    old_valid, old_depth, cam: Intrinsics, skip_step: int = 2,
                                    sigma_depth: float = 0.01) -> EmmResult:
    """Bidirectional EMM (node.cpp:1520-1554): both directions' counts
    summed."""
    a = observation_likelihood_dense(se3.inv(new_T_old), new_points, new_valid, old_depth, cam,
                                     skip_step, sigma_depth)
    b = observation_likelihood_dense(new_T_old, old_points, old_valid, new_depth, cam,
                                     skip_step, sigma_depth)
    n_in = a.inliers + b.inliers
    n_out = a.outliers + b.outliers
    quality = n_in.float() / torch.clamp(n_in + n_out, min=1).float()
    return EmmResult(n_in, n_out, a.occluded + b.occluded, a.all_projected + b.all_projected,
                     quality)


def rejection_significance(old_T_new, new_points, new_valid, old_depth, cam: Intrinsics,
                           skip_step: int = 2, sigma_depth: float = 0.01) -> torch.Tensor:
    """Chi-square variant of the EMM (misc.cpp:974-1134): the chi^2 CDF of
    the summed squared depth Mahalanobis distances of the projected points,
    with as many degrees of freedom as points counted; (B,) float32, 0
    where none counts."""
    pts, val = _strided(new_points, new_valid, skip_step)
    z_pred, in_img, ui, vi = _project(old_T_new, pts, val, cam)
    B = z_pred.shape[0]
    lohi = emm_pool_maps(old_depth).reshape(old_depth.shape[0], -1)
    if lohi.shape[0] != B:
        lohi = lohi.expand(B, -1)
    lo, hi = emm_unpack(torch.gather(lohi, 1, vi * cam.width + ui))
    has_obs = torch.isfinite(lo)
    best_obs = torch.where(has_obs, torch.minimum(torch.maximum(z_pred, lo), hi), 0.0)
    counted = in_img & has_obs
    joint = depth_covariance(z_pred, sigma_depth) + depth_covariance(best_obs, sigma_depth)
    m2 = torch.where(counted, (best_obs - z_pred) ** 2 / joint, 0.0)
    k = counted.float().sum(dim=-1)
    total = m2.sum(dim=-1)
    p = torch.special.gammainc(k / 2.0, total / 2.0)
    return torch.where(k > 0, p, torch.zeros_like(p))


def observation_criterion_met(res: EmmResult, observability_threshold: float) -> torch.Tensor:
    """quality > threshold and inliers / all > 0.25 (misc.cpp:1136-1148);
    always met where the threshold is <= 0."""
    if observability_threshold <= 0:
        return torch.ones_like(res.inliers, dtype=torch.bool)
    frac = res.inliers.float() / torch.clamp(res.all_projected, min=1).float()
    return (res.quality > observability_threshold) & (frac > 0.25)
