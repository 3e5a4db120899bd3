"""The host's decisions on one frame, written plainly: RGBDSLAMv2's rules
for its candidates' comparisons (graph_manager.cpp:421-809) as the
configurations set them.

A frame was compared with B candidate slots (node ids, a candidate
repeated to fill the slots). Each slot's comparison gives a transform
(candidate from new frame), its inlier count and RMSE, whether RANSAC
found one, and the EMM's quality and inlier share. Then:

* a candidate is judged once, in its first slot: accepted where RANSAC
  found a transform, the EMM passes it (quality above
  ``observability_threshold`` and more than a quarter of its points
  inliers; no test where the threshold is 0) and, for the predecessor
  alone, the motion is possible (translation at most
  ``max_translation_meter`` and rotation at most ``max_rotation_degree``
  a second, over the time between the two frames, at least 1 ms);
* above ``max_connections`` (where positive) accepted candidates, the
  ones with the most inliers stay;
* the frame is redundant where its predecessor was kept and moved less
  than ``min_translation_meter`` and ``min_rotation_degree`` a second;
* every kept candidate gives an edge (candidate, new node, transform,
  information): inliers over max(RMSE^2, 1e-4) times the identity, or,
  with a 6x6 information from the comparison, that matrix scaled to the
  same trace; sequential where the candidate is the predecessor or lies
  within ``geodesic_depth`` edges of it, else a loop closure;
* the new node is posed from the kept candidate with the most inliers
  (the first slot among equals), or from the predecessor at identity;
* the frame becomes a node where it is not redundant and has an edge, or
  has none but ``keep_all_nodes`` holds, or ``keep_good_nodes`` holds and
  it has more than ``min_keypoints`` keypoints (a constant-position edge
  to the predecessor then); else it is dropped.

Plain NumPy; nothing here imports the program, JAX or the JAX package.
"""
from __future__ import annotations

import numpy as np

SEQUENTIAL, LOOP = 0, 1


def _speeds(T: np.ndarray, dt: float):
    """(m/s, deg/s) of the transforms T (..., 4, 4) over dt seconds."""
    dt = max(dt, 1e-3)
    T = np.asarray(T, np.float64)
    trans = np.linalg.norm(T[..., :3, 3], axis=-1) / dt
    cos = (np.trace(T[..., :3, :3], axis1=-2, axis2=-1) - 1.0) / 2.0
    return trans, np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) / dt


def _within(edges: np.ndarray, start: int, depth: int) -> set:
    """The nodes at most `depth` edges (pairs (i, j), either way) from start."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    n = max(int(edges.max(initial=start)), start) + 1
    A = np.zeros((n, n), bool)
    A[edges[:, 0], edges[:, 1]] = A[edges[:, 1], edges[:, 0]] = True
    reach = np.zeros(n, bool)
    reach[start] = True
    for _ in range(depth):
        reach = reach | A[reach].any(axis=0)
    return set(np.nonzero(reach)[0].tolist())


def decide(slots, cmp: dict, stamp: float, stamps, new_id: int, params: dict,
           graph_edges, n_keypoints: int) -> dict:
    """The decisions on one frame. slots: the B candidate ids; cmp: arrays
    transform (B, 4, 4), n_inliers, rmse, ransac_ok, emm_quality,
    emm_inlier_frac and info6 ((B, 6, 6) or None); stamps: the nodes'
    stamps; graph_edges: the graph's edges (i, j) so far. Returns accepted
    (the kept slots), redundant, node (whether the frame becomes a node),
    base (id, transform) and edges [(i, j, transform, info, kind)]."""
    slots = np.asarray(slots, np.int64)
    pred = new_id - 1
    first = np.zeros(len(slots), bool)
    first[np.unique(slots, return_index=True)[1]] = True
    ok = first & np.asarray(cmp["ransac_ok"], bool)
    thr = params["observability_threshold"]
    if thr > 0:
        ok &= (np.asarray(cmp["emm_quality"]) > thr) & (np.asarray(cmp["emm_inlier_frac"]) > 0.25)
    for b in np.nonzero(ok & (slots == pred))[0]:
        t, r = _speeds(cmp["transform"][b], abs(stamp - stamps[slots[b]]))
        ok[b] = t <= params["max_translation_meter"] and r <= params["max_rotation_degree"]
    kept = np.nonzero(ok)[0]
    inl = np.asarray(cmp["n_inliers"], np.int64)
    mc = params["max_connections"]
    if mc > 0 and len(kept) > mc:
        kept = kept[np.argsort(-inl[kept], kind="stable")[:mc]]
    dt_pred = max(stamp - stamps[pred], 1e-3)
    at_pred = kept[slots[kept] == pred]
    redundant = False
    if len(at_pred):
        t, r = _speeds(cmp["transform"][at_pred[0]], dt_pred)
        redundant = bool(t < params["min_translation_meter"] and r < params["min_rotation_degree"])
    near = _within(graph_edges, pred, params["geodesic_depth"]) | {pred}
    edges = []
    for b in kept:
        info = np.eye(6) * (inl[b] / max(float(cmp["rmse"][b]) ** 2, 1e-4))
        h = None if cmp.get("info6") is None else np.asarray(cmp["info6"][b], np.float64)
        if h is not None and np.isfinite(h).all() and np.trace(h) > 0:
            info = h * (info[0, 0] * 6.0 / np.trace(h))
        edges.append((int(slots[b]), new_id, np.asarray(cmp["transform"][b], np.float64), info,
                      SEQUENTIAL if int(slots[b]) in near else LOOP))
    base = (pred, np.eye(4))
    if len(kept):
        best = min(b for b in kept if inl[b] == inl[kept].max())
        base = (int(slots[best]), np.asarray(cmp["transform"][best], np.float64))
    keep_anyway = params["keep_all_nodes"] or (params["keep_good_nodes"]
                                               and n_keypoints > params["min_keypoints"])
    node = not redundant and (bool(edges) or keep_anyway)
    return {"accepted": sorted(kept.tolist()), "redundant": redundant, "node": node,
            "base": base, "edges": edges}
