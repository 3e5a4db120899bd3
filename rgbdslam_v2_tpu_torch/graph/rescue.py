"""The ICP rescue of frames whose visual matching failed (``use_icp``).

Port of the rescue half of ``rgbdslam_v2_tpu/graph/manager.py``, the
reference's ICP fallback (node.cpp:1381-1413):

* :func:`icp_rescue_body` (JAX ``_icp_rescue_body``): dense ICP of the new
  frame's depth against a candidate's (GICP or point-to-plane), then the
  two-way observation likelihood (EMM) of the result, as a visual edge is
  gated. Batched over a leading candidate dimension where the JAX package
  vmaps (``_icp_rescue_batch_kernel``), which is the default path's inline
  rescue of its visually failed candidates.
* :func:`retro_rescue` (JAX ``_retro_rescue_kernel``): the keep-all fast
  path's retroactive rescue of the constant-position fallback edges a
  drain found. Items run in order, each seeded by constant velocity from
  the two poses before it, or, right after a rescued predecessor, by that
  rescue's result (the chain carries across dispatches through ``prev``);
  an accepted rescue rewrites its fallback edge's measurement and
  information and its node's pose in place. No host read: the verdicts
  come back as a flags tensor the caller copies asynchronously.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..core import se3
from ..core.camera import Intrinsics, backproject_grid
from ..ops.emm import emm_pool_maps, observation_likelihood
from ..ops.icp import icp_plane_to_plane, icp_point_to_plane
from ..optim.pose_graph import GraphState


class RescueResult(NamedTuple):
    transform: torch.Tensor  # (B, 4, 4) cand_T_new
    rmse: torch.Tensor  # (B,)
    n_pairs: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool
    emm_quality: torch.Tensor  # (B,)
    emm_inlier_frac: torch.Tensor  # (B,)


def min_pairs(cam_small: Intrinsics) -> int:
    """Correspondences an ICP result needs: 50 at bench scale, scaled down
    with the sampled area of small grids (never below 16)."""
    n_src = (cam_small.height // 4) * (cam_small.width // 4)
    return min(50, max(16, n_src // 16))


def icp_rescue_body(T0: torch.Tensor, new_depth: torch.Tensor, cand_depth: torch.Tensor,
                    cam_small: Intrinsics, iterations: int, emm_skip: int,
                    sigma_depth: float, variant: str = "gicp",
                    new_lohi: torch.Tensor = None,
                    cand_lohi: torch.Tensor = None) -> RescueResult:
    """ICP from seeds T0 (B, 4, 4) of the new frame's stride-s depth (h, w)
    or (B, h, w) against B candidates' (B, h, w), and the two-way EMM of
    each result at the EMM stride. new_lohi / cand_lohi: the depths'
    packed pool maps (B, h*w) where the store holds them, else computed."""
    B = T0.shape[0]
    e = emm_skip
    new_depth = new_depth.expand(B, *cand_depth.shape[-2:])
    new_pts = backproject_grid(new_depth, cam_small)
    cand_pts = backproject_grid(cand_depth, cam_small)
    nv, cv = new_depth > 0, cand_depth > 0
    icp = icp_plane_to_plane if variant == "gicp" else icp_point_to_plane
    res = icp(T0, new_pts, nv, cand_pts, cv, iterations=iterations,
              min_pairs=min_pairs(cam_small))
    if new_lohi is None:
        new_lohi = emm_pool_maps(new_depth).reshape(B, -1)
    if cand_lohi is None:
        cand_lohi = emm_pool_maps(cand_depth).reshape(B, -1)
    rows = torch.arange(B, device=T0.device)

    def strided(pts, valid):
        return pts[:, ::e, ::e].reshape(B, -1, 3), valid[:, ::e, ::e].reshape(B, -1)

    a = observation_likelihood(res.transform, *strided(new_pts, nv), cam_small, cand_lohi,
                               rows, sigma_depth=sigma_depth)
    b = observation_likelihood(se3.inv(res.transform), *strided(cand_pts, cv), cam_small,
                               new_lohi, rows, sigma_depth=sigma_depth)
    n_in = a.inliers + b.inliers
    n_out = a.outliers + b.outliers
    n_all = a.all_projected + b.all_projected
    q = n_in.float() / torch.clamp(n_in + n_out, min=1).float()
    frac = n_in.float() / torch.clamp(n_all, min=1).float()
    return RescueResult(res.transform, res.rmse, res.n_pairs, res.converged, q, frac)


def rescue_information(n_pairs: torch.Tensor, rmse: torch.Tensor) -> torch.Tensor:
    """Edge information of a rescue: n_pairs / (rmse^2 + 4e-4) on the
    diagonal, clipped to [0, 1e6]."""
    scale = torch.clamp(n_pairs.float() / (rmse * rmse + 4e-4), 0.0, 1e6)
    return torch.eye(6, device=rmse.device) * scale[..., None, None]


def retro_rescue(graph: GraphState, depth: torch.Tensor, emm_lohi: torch.Tensor,
                 new_ids: Sequence[int], slots: Sequence[int],
                 prev: Tuple[torch.Tensor, torch.Tensor, int], cam_small: Intrinsics,
                 iterations: int, emm_skip: int, sigma_depth: float, variant: str,
                 obs_threshold: float):
    """Rescue the fallback edges (edge slots `slots`) of nodes new_ids, each
    against its predecessor new_id - 1 (host ints). depth / emm_lohi: the
    store's (N, h*w) planes, read only. prev = (T (4, 4), ok () bool
    tensor, node id) of the last rescue before these (ok False: no chain).
    Writes the accepted rescues into graph in place, indexing with host
    ints only (no host read, no pageable copy); returns (flags (n, 4)
    float32 [ok, n_pairs, rmse, emm_quality], (T, ok) of the last item)."""
    h, w = cam_small.height, cam_small.width
    pT, pok, pid = prev
    poses = graph.poses.clone()  # every seed reads the poses as they were
    ppose = poses[pid]
    flags = []
    for nid, slot in zip(new_ids, slots):
        pred = nid - 1
        const_vel = se3.inv(poses[max(pred - 1, 0)]) @ poses[pred]
        consec = pok & (pred == pid)
        seed = torch.where(consec, pT, const_vel)
        p_pred = torch.where(consec, ppose, poses[pred])
        r = icp_rescue_body(seed[None], depth[nid].view(1, h, w), depth[pred].view(1, h, w),
                            cam_small, iterations, emm_skip, sigma_depth, variant,
                            new_lohi=emm_lohi[nid : nid + 1], cand_lohi=emm_lohi[pred : pred + 1])
        ok = r.converged[0]
        if obs_threshold > 0:
            ok = ok & (r.emm_quality[0] > obs_threshold) & (r.emm_inlier_frac[0] > 0.25)
        T = r.transform[0]
        new_pose = p_pred @ T
        # an accepted rescue rewrites its edge and re-poses its node, so the
        # online optimizer (and the next drain's seeds) start from it; a
        # rejected one leaves both as they were
        graph.edge_meas[slot] = torch.where(ok, T, graph.edge_meas[slot])
        graph.edge_info[slot] = torch.where(ok, rescue_information(r.n_pairs[0], r.rmse[0]),
                                            graph.edge_info[slot])
        graph.poses[nid] = torch.where(ok, new_pose, poses[nid])
        flags.append(torch.stack([ok.float(), r.n_pairs[0].float(), r.rmse[0],
                                  r.emm_quality[0]]))
        pT, pok, pid = torch.where(ok, T, seed), ok, nid
        ppose = torch.where(ok, new_pose, poses[nid])
    return torch.stack(flags), (pT, pok)
