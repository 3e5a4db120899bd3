"""Batched candidate comparison: matching, RANSAC and two-way EMM.

Port of ``rgbdslam_v2_tpu/graph/compare.py::compare_to_candidates``: all B
candidates in one batched call, the JAX vmaps written out as a leading
batch dimension; the pooled EMM or the exact one (``emm_exact``), the
projective refinement in RANSAC (``projective_iterations``), and the GN
pose information of each candidate where ``edge_info_mode`` is
``"hessian"``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import se3
from ..core.camera import Intrinsics, backproject_grid
from ..core.noise import point_covariance_diag
from ..models.types import Keypoints
from ..ops.emm import emm_pool_maps, observation_likelihood, observation_likelihood_exact
from ..ops.matching import match_descriptors
from ..ops.registration import pose_information, ransac_register
from .node_store import NodeStore


class CompareResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) cand_T_new
    n_inliers: torch.Tensor  # (B,) int32
    rmse: torch.Tensor  # (B,)
    ransac_ok: torch.Tensor  # (B,) bool
    emm_quality: torch.Tensor  # (B,)
    emm_inlier_frac: torch.Tensor  # (B,)
    info6: Optional[torch.Tensor] = None  # (B, 6, 6) GN pose information (hessian mode)


class CompareSummary(NamedTuple):
    """Host copy of a CompareResult plus the new frame's valid keypoint
    count: what the host-decision path reads, moved in ONE device->host
    copy of a flat float32 vector (B*16 + 5B + 1 values, and B*36 more
    for info6 in hessian mode)."""

    transform: np.ndarray  # (B, 4, 4) float32
    n_inliers: np.ndarray  # (B,) int
    rmse: np.ndarray  # (B,) float32
    ransac_ok: np.ndarray  # (B,) bool
    emm_quality: np.ndarray  # (B,) float32
    emm_inlier_frac: np.ndarray  # (B,) float32
    n_valid_kp: int
    info6: Optional[np.ndarray] = None  # (B, 6, 6) float32 in hessian mode

    @staticmethod
    def pack(res: CompareResult, n_valid_kp: torch.Tensor) -> torch.Tensor:
        info = [] if res.info6 is None else [res.info6.reshape(-1)]
        return torch.cat([
            res.transform.reshape(-1), res.n_inliers.float(), res.rmse,
            res.ransac_ok.float(), res.emm_quality, res.emm_inlier_frac,
            n_valid_kp.float().reshape(1), *info,
        ])

    @classmethod
    def unpack(cls, flat: np.ndarray, B: int) -> "CompareSummary":
        v = flat[16 * B :]
        tail = v[5 * B + 1 :]
        return cls(
            transform=flat[: 16 * B].reshape(B, 4, 4),
            n_inliers=v[:B].astype(int),
            rmse=v[B : 2 * B],
            ransac_ok=v[2 * B : 3 * B] > 0.5,
            emm_quality=v[3 * B : 4 * B],
            emm_inlier_frac=v[4 * B : 5 * B],
            n_valid_kp=int(v[5 * B]),
            info6=tail.reshape(B, 6, 6) if tail.size else None,
        )


def strided_points(zs: torch.Tensor, cam_small: Intrinsics, e: int) -> torch.Tensor:
    """(..., hs, ws) depth samples at pixels (i*e, j*e) -> (..., hs, ws, 3)."""
    hs, ws = zs.shape[-2:]
    us = (torch.arange(ws, device=zs.device) * e).float()
    vs = (torch.arange(hs, device=zs.device) * e).float()
    x = (us[None, :] - cam_small.cx) * zs / cam_small.fx
    y = (vs[:, None] - cam_small.cy) * zs / cam_small.fy
    return torch.stack([x, y, zs], dim=-1)


def compare_to_candidates(
    new_kp: Keypoints,
    new_depth_small: torch.Tensor,  # (h, w) stride-s depth of the new frame
    store: NodeStore,
    cand_idx: torch.Tensor,  # (B,) long node ids
    generator: torch.Generator,
    cam_small: Intrinsics,
    cam_fx: float = 525.0,
    cam_fy: float = 525.0,
    max_matches: int = 300,
    ratio: float = 0.95,
    n_hypotheses: int = 256,
    max_mahal_sq: float = 9.0,
    min_inliers: int = 12,
    emm_skip: int = 1,
    sigma_depth: float = 0.01,
    sample_size: int = 4,
    refine_iterations: int = 6,
    projective_iterations: int = 0,
    cam_cx: float = 319.5,
    cam_cy: float = 239.5,
    emm_exact: bool = False,
    edge_info_mode: str = "scalar",
) -> CompareResult:
    B = cand_idx.shape[0]
    h, w = cam_small.height, cam_small.width
    e = emm_skip
    hs, ws = -(-h // e), -(-w // e)

    # ---- matching: B batched knn2 + ratio + dedup -------------------------
    # the store may hold descriptors in another dtype (tpu_descriptor_dtype)
    m = match_descriptors(new_kp.desc.to(store.desc.dtype), new_kp.valid,
                          store.desc[cand_idx], store.kp_valid[cand_idx], max_matches, ratio)
    src = new_kp.xyz[m.src_idx]  # (B, M, 3)
    c_xyz = store.xyz[cand_idx]
    dst = torch.gather(c_xyz, 1, m.dst_idx[..., None].expand(-1, -1, 3))

    # ---- RANSAC over all candidates at once -------------------------------
    reg = ransac_register(
        generator, src, dst, m.dist, m.valid, cam_fx=cam_fx, cam_fy=cam_fy,
        n_hypotheses=n_hypotheses, sample_size=sample_size,
        max_mahal_sq=max_mahal_sq, refine_iterations=refine_iterations,
        min_inliers=min_inliers, sigma_depth=sigma_depth,
        projective_iterations=projective_iterations, cam_cx=cam_cx, cam_cy=cam_cy,
    )

    # ---- bidirectional EMM at the storage stride --------------------------
    if emm_exact:
        # tpu_emm_exact: the reference's verbatim 9-sample search with the
        # cloud-stride covariance inflation, on the candidates' full rows
        c_depth = store.depth[cand_idx].reshape(B, h, w)
        a = observation_likelihood_exact(
            reg.transform, backproject_grid(new_depth_small, cam_small)[None],
            (new_depth_small > 0)[None], c_depth, cam_small, e, sigma_depth, cov_scale=float(e))
        b = observation_likelihood_exact(
            se3.inv(reg.transform), backproject_grid(c_depth, cam_small), c_depth > 0,
            new_depth_small[None], cam_small, e, sigma_depth, cov_scale=float(e))
    else:
        # direction a: new points into each candidate camera, looked up in
        # the store's precomputed pool rows; direction b: candidate points
        # (their depth samples at the EMM stride) into the new camera
        flat = ((torch.arange(hs, device=cand_idx.device) * e)[:, None] * w
                + (torch.arange(ws, device=cand_idx.device) * e)[None, :]).reshape(-1)
        c_zs = store.depth[cand_idx[:, None], flat[None, :]].reshape(B, hs, ws)
        n_zs = new_depth_small[::e, ::e]
        new_pts = strided_points(n_zs, cam_small, e).reshape(1, -1, 3)
        a = observation_likelihood(
            reg.transform, new_pts, (n_zs > 0).reshape(1, -1), cam_small,
            store.emm_lohi, cand_idx, sigma_depth=sigma_depth)
        new_lohi = emm_pool_maps(new_depth_small).reshape(1, -1)
        b = observation_likelihood(
            se3.inv(reg.transform), strided_points(c_zs, cam_small, e).reshape(B, -1, 3),
            (c_zs > 0).reshape(B, -1), cam_small, new_lohi, None, sigma_depth=sigma_depth)
    n_in = a.inliers + b.inliers
    n_out = a.outliers + b.outliers
    n_all = a.all_projected + b.all_projected
    q = n_in.float() / torch.clamp(n_in + n_out, min=1).float()
    frac = n_in.float() / torch.clamp(n_all, min=1).float()

    info6 = None
    if edge_info_mode == "hessian":
        cov = [point_covariance_diag(x[..., 2], cam_fx, cam_fy, sigma_depth) for x in (src, dst)]
        info6 = pose_information(reg.transform, src, dst, *cov, reg.inliers)

    return CompareResult(
        transform=reg.transform, n_inliers=reg.n_inliers, rmse=reg.rmse,
        ransac_ok=reg.success, emm_quality=q, emm_inlier_frac=frac, info6=info6,
    )
