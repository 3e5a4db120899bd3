"""The per-frame keep-all step: extract, compare, decide, commit.

Port of ``rgbdslam_v2_tpu/graph/device_step.py`` (``_compute_body`` and
``_commit_body``, ``StepSummary``). The JAX package splits compute and
commit into two programs only to steer XLA's copy insertion; here they are
one function that writes the node row and its B+1 edge slots in place.
All per-frame decisions stay on the device; the host reads the packed
(4B+2,) summary later, at a drain.

``commit_node`` is the in-place write shared with the host-decision path
(JAX ``manager._commit_node``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..optim.pose_graph import GraphState
from .compare import compare_to_candidates
from .ingest import prepare_and_extract
from .node_store import NodeStore


class StepSummary(NamedTuple):
    """Per-frame outputs for host bookkeeping, unpacked from the flat
    (4B+2,) float32 vector the step returns."""

    accepted: np.ndarray  # (B,) bool
    n_inliers: np.ndarray  # (B,) int
    rmse: np.ndarray
    emm_quality: np.ndarray
    fallback_used: bool
    n_valid_kp: int

    @classmethod
    def unpack(cls, flat: np.ndarray, B: int) -> "StepSummary":
        return cls(
            accepted=flat[:B] > 0.5,
            n_inliers=flat[B : 2 * B].astype(int),
            rmse=flat[2 * B : 3 * B],
            emm_quality=flat[3 * B : 4 * B],
            fallback_used=bool(flat[4 * B] > 0.5),
            n_valid_kp=int(flat[4 * B + 1]),
        )


def commit_node(store: NodeStore, graph: GraphState, new_id: int, kp, depth_small,
                color_small, base_id: torch.Tensor, base_T_new: torch.Tensor,
                edge_start: int, e_i: torch.Tensor, e_j, e_meas: torch.Tensor,
                e_info: torch.Tensor, e_active: torch.Tensor) -> None:
    """Insert node new_id, posed at poses[base_id] @ base_T_new (base_id a
    (1,) long tensor), and write the edge slots edge_start.. where e_active,
    in place. e_j is a (n,) tensor or one node id for every slot."""
    store.insert(new_id, kp, depth_small, color_small)
    graph.poses[new_id] = graph.poses.index_select(0, base_id)[0] @ base_T_new
    graph.node_active[new_id].fill_(True)  # fill_: a Python value set would sync
    sl = slice(edge_start, edge_start + e_i.shape[0])
    graph.edge_i[sl] = torch.where(e_active, e_i, graph.edge_i[sl])
    graph.edge_j[sl] = torch.where(e_active, e_j, graph.edge_j[sl])
    graph.edge_meas[sl] = torch.where(e_active[:, None, None], e_meas, graph.edge_meas[sl])
    graph.edge_info[sl] = torch.where(e_active[:, None, None], e_info, graph.edge_info[sl])
    graph.edge_active[sl] |= e_active


def slam_step(
    store: NodeStore,
    graph: GraphState,
    packed: torch.Tensor,  # (L,) u8 yc12 buffer on the device
    new_id: int,
    pred_id: int,
    cand_idx: torch.Tensor,  # (B,) long
    cand_dup: torch.Tensor,  # (B,) bool, padding duplicates
    cand_dt: torch.Tensor,  # (B,) float32 |t_new - t_cand|
    edge_start: int,
    generator: torch.Generator,
    *,
    extractor,
    cam,
    cam_small,
    stride: int,
    depth_bits: int,
    min_depth: float,
    max_depth: float,
    max_matches: int,
    ratio: float,
    n_hypotheses: int,
    max_mahal_sq: float,
    min_inliers: int,
    emm_skip: int,
    sigma_depth: float,
    sample_size: int,
    refine_iterations: int,
    observability_threshold: float,
    max_translation_per_s: float,
    max_rotation_deg_per_s: float,
    const_pos_information: float,
    use_feature_min_depth: bool,
) -> torch.Tensor:
    """One frame, written into store/graph in place. Returns the (4B+2,)
    float32 summary on the device."""
    kp, depth_small, color_small = prepare_and_extract(
        extractor, cam, stride, min_depth, max_depth, use_feature_min_depth,
        packed, depth_bits)
    res = compare_to_candidates(
        kp, depth_small, store, cand_idx, generator, cam_small,
        cam_fx=cam.fx, cam_fy=cam.fy, max_matches=max_matches, ratio=ratio,
        n_hypotheses=n_hypotheses, max_mahal_sq=max_mahal_sq,
        min_inliers=min_inliers, emm_skip=emm_skip, sigma_depth=sigma_depth,
        sample_size=sample_size, refine_iterations=refine_iterations,
    )
    dev = packed.device
    B = cand_idx.shape[0]

    # ---- accept/reject (nodeComparisons decision logic) -------------------
    if observability_threshold <= 0.0:
        emm_ok = torch.ones(B, dtype=torch.bool, device=dev)
    else:
        emm_ok = (res.emm_quality > observability_threshold) & (res.emm_inlier_frac > 0.25)
    T = res.transform
    trans = torch.linalg.norm(T[:, :3, 3], dim=-1)
    tr = T[:, 0, 0] + T[:, 1, 1] + T[:, 2, 2]
    rot_deg = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)) * (180.0 / math.pi)
    dt = torch.clamp(cand_dt, min=1e-3)
    sane = (trans / dt <= max_translation_per_s) & (rot_deg / dt <= max_rotation_deg_per_s)
    is_pred = cand_idx == pred_id
    accept = res.ransac_ok & emm_ok & ~cand_dup & (sane | ~is_pred)

    # indices stay on the device (index_select, not t[0-dim tensor], which
    # would read the index back to the host)
    any_acc = accept.any()
    score = torch.where(accept, res.n_inliers, -1)
    best = torch.argmax(score).view(1)
    pred = cand_idx.new_full((), pred_id)
    base_id = torch.where(any_acc, cand_idx.index_select(0, best)[0], pred)
    eye4 = torch.eye(4, device=dev)
    base_T_new = torch.where(any_acc, T.index_select(0, best)[0], eye4)

    # ---- edge batch: B visual slots + 1 fallback slot ---------------------
    info_scale = res.n_inliers.float() / torch.clamp(res.rmse * res.rmse, min=1e-4)
    eye6 = torch.eye(6, device=dev)
    vis_info = info_scale[:, None, None] * eye6
    fallback = ~any_acc  # keep_all: a constant-position edge when none accepted
    e_i = torch.cat([cand_idx, pred[None]]).to(torch.int32)
    e_meas = torch.cat([T, eye4[None]], dim=0)
    fb_info = const_pos_information / torch.clamp(cand_dt[0], min=1e-3)
    e_info = torch.cat([vis_info, (fb_info * eye6)[None]], dim=0)
    e_active = torch.cat([accept, fallback[None]])

    commit_node(store, graph, new_id, kp, depth_small, color_small, base_id.view(1),
                base_T_new, edge_start, e_i, new_id, e_meas, e_info, e_active)

    return torch.cat([
        accept.float(), res.n_inliers.float(), res.rmse, res.emm_quality,
        fallback.float()[None], kp.count().float()[None],
    ])
