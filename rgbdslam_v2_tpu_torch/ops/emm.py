"""Environment Measurement Model: depth-reprojection validation.

Port of ``rgbdslam_v2_tpu/ops/emm.py`` (``emm_pool_maps``, ``emm_unpack``,
``observation_likelihood`` with the store-row lookup), batched over a
leading candidate dimension.

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
    dev = old_T_new.device
    moved = se3.apply(old_T_new, new_points)  # (B, N, 3)
    z_pred = moved[..., 2]
    safe_z = torch.where(z_pred.abs() < 1e-6, torch.full_like(z_pred, 1e-6), z_pred)
    u = moved[..., 0] / safe_z * cam.fx + cam.cx
    v = moved[..., 1] / safe_z * cam.fy + cam.cy
    in_img = (new_valid & (z_pred > 0.1) & (u >= 1.0) & (u <= cam.width - 2.0)
              & (v >= 1.0) & (v <= cam.height - 2.0))
    ui = torch.clamp(torch.round(u).long(), 0, cam.width - 1)
    vi = torch.clamp(torch.round(v).long(), 0, cam.height - 1)
    pix = vi * cam.width + ui
    if old_lohi_row is None:
        old_lohi_row = torch.zeros(B, dtype=torch.long, device=dev)
    packed = old_lohi[old_lohi_row[:, None], pix]
    lo, hi = emm_unpack(packed)
    has_obs = torch.isfinite(lo)
    best_obs = torch.where(has_obs, torch.minimum(torch.maximum(z_pred, lo), hi), 0.0)
    counted = in_img & has_obs
    sigma2 = depth_covariance(z_pred, sigma_depth) + depth_covariance(best_obs, sigma_depth)
    gate = gate_sigmas * torch.sqrt(sigma2)
    diff = best_obs - z_pred
    is_inlier = counted & (diff.abs() <= gate)
    is_occluded = counted & (diff < -gate)
    is_outlier = counted & (diff > gate)
    n_in = is_inlier.sum(dim=-1, dtype=torch.int32)
    n_out = is_outlier.sum(dim=-1, dtype=torch.int32)
    n_occ = is_occluded.sum(dim=-1, dtype=torch.int32)
    n_all = counted.sum(dim=-1, dtype=torch.int32)
    quality = n_in.float() / torch.clamp(n_in + n_out, min=1).float()
    return EmmResult(n_in, n_out, n_occ, n_all, quality)
