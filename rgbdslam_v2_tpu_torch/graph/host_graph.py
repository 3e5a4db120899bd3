"""Host-side graph bookkeeping and decisions (numpy and Python only, no
tensors).

Port of the bookkeeping half of ``rgbdslam_v2_tpu/graph/manager.py``:
``select_candidates``, ``_frame_slots``, the per-frame body of
``_drain_batch``, ``_geodesic_set``, ``_fixation_mask``, the host mirrors
of edge metadata, and the host-decision path of ``add_frame``: the motion
gates (``_motion_magnitude``, ``_motion_small``, ``_motion_sane``),
``MatchDecision`` and the accept/reject loop, the ``max_connections`` cut,
the redundancy drop, edge building, keyframes, the ``clear_non_keyframes``
queue, ``delete_last_frame``'s bookkeeping, the subgraph selection of
``_optimize_inaffected``, and the edge bookkeeping of the ICP rescues
(the fallback edges a drain hands to ``_dispatch_retro_rescue``,
``_consume_rescues``' retyping, the ICP edges of ``add_frame``) and the
place of the appearance retrieval's hits among the candidates. The
decisions are functions on numpy arrays, so a test can feed them fixed
comparison results. ``graph/manager.py`` holds the device half.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np

EDGE_SEQUENTIAL = 0
EDGE_LOOP = 1
EDGE_ODOMETRY = 2
EDGE_CONST_POSITION = 3


@dataclasses.dataclass
class MatchDecision:
    """Host-side record of one accepted/rejected candidate comparison."""

    cand_id: int
    accepted: bool
    reason: str
    n_inliers: int = 0
    rmse: float = 0.0
    emm_quality: float = 1.0


def motion_magnitude(T: np.ndarray, dt: float) -> Tuple[float, float]:
    """Translation m/s and rotation deg/s of a 4x4 transform over dt."""
    dt = max(dt, 1e-3)
    trans = float(np.linalg.norm(T[:3, 3])) / dt
    tr = float(T[0, 0] + T[1, 1] + T[2, 2])
    rot = float(np.degrees(np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0)))) / dt
    return trans, rot


def motion_small(T: np.ndarray, dt: float, params) -> bool:
    """isSmallTrafo: motion below the per-second minimum -> redundant frame."""
    trans, rot = motion_magnitude(T, dt)
    return trans < params["min_translation_meter"] and rot < params["min_rotation_degree"]


def motion_sane(T: np.ndarray, dt: float, params) -> bool:
    """isBigTrafo inverse: reject impossibly fast motion."""
    trans, rot = motion_magnitude(T, dt)
    return trans <= params["max_translation_meter"] and rot <= params["max_rotation_degree"]


def decide_matches(padded: List[int], cmp, timestamp: float, timestamps: List[float],
                   pred_id: int, params) -> Tuple[List[MatchDecision], List[int]]:
    """nodeComparisons' accept/reject over the distinct candidates, then the
    max_connections cut ("enough is enough", node.cpp:1310-1312: keep the
    best by inliers). cmp holds host arrays (transform (B, 4, 4),
    n_inliers, rmse, ransac_ok, emm_quality, emm_inlier_frac). Returns the
    decisions and the accepted positions into `padded`."""
    decisions: List[MatchDecision] = []
    accepted: List[int] = []
    seen: Set[int] = set()
    emm_thresh = params["observability_threshold"]
    for b, cid in enumerate(padded):
        if cid in seen:
            continue
        seen.add(cid)
        d = MatchDecision(cand_id=cid, accepted=False, reason="",
                          n_inliers=int(cmp.n_inliers[b]), rmse=float(cmp.rmse[b]),
                          emm_quality=float(cmp.emm_quality[b]))
        if not cmp.ransac_ok[b]:
            d.reason = "ransac_failed"
        elif emm_thresh > 0 and not (cmp.emm_quality[b] > emm_thresh
                                     and cmp.emm_inlier_frac[b] > 0.25):
            d.reason = "emm_rejected"
        else:
            dt = max(abs(timestamp - timestamps[cid]), 1e-3)
            # the sanity gate applies to sequential motion only (loop
            # closures may be large)
            if cid == pred_id and not motion_sane(cmp.transform[b], dt, params):
                d.reason = "motion_insane"
            else:
                d.accepted = True
                d.reason = "ok"
                accepted.append(b)
        decisions.append(d)
    mc = params["max_connections"]
    if mc > 0 and len(accepted) > mc:
        accepted = sorted(accepted, key=lambda b: -int(cmp.n_inliers[b]))[:mc]
    return decisions, accepted


def is_redundant(padded: List[int], accepted: List[int], cmp, pred_id: int, dt_pred: float,
                 params) -> bool:
    """Redundancy filter: the accepted predecessor match moved too little."""
    pred_pos = next((i for i, b in enumerate(accepted) if padded[b] == pred_id), None)
    return pred_pos is not None and motion_small(cmp.transform[accepted[pred_pos]],
                                                 dt_pred, params)


def build_edges(padded: List[int], accepted: List[int], cmp, pred_id: int, new_id: int,
                geodesic: Set[int], icp: Optional[Dict[int, tuple]] = None):
    """Visual edges of the accepted matches, then the ICP-rescued edges of
    `icp` ({cand_id: (T, info6x6, n_pairs, rmse)}, use_icp), each typed
    sequential (the predecessor or inside its geodesic neighbourhood) or
    loop, and the pose anchor: the best match by inliers, else the
    predecessor's ICP edge, else the predecessor at identity. Returns
    (base_id, base_T_new, [(i, j, meas, info6x6, etype)])."""
    edges = []
    base_id, base_T_new = pred_id, np.eye(4, dtype=np.float32)
    if accepted:
        best_b = max(accepted, key=lambda b: cmp.n_inliers[b])
        base_id = padded[best_b]
        base_T_new = np.asarray(cmp.transform[best_b], np.float32)
        for b in accepted:
            cid = padded[b]
            info_scale = float(cmp.n_inliers[b]) / max(float(cmp.rmse[b]) ** 2, 1e-4)
            info = np.eye(6, dtype=np.float32) * info_scale
            if cmp.info6 is not None:  # tpu_edge_info=hessian, trace-matched
                h6 = np.asarray(cmp.info6[b], np.float32)
                tr = float(np.trace(h6)) / 6.0
                if np.isfinite(h6).all() and tr > 0:
                    info = h6 * (info_scale / tr)
            edges.append((cid, new_id, np.asarray(cmp.transform[b], np.float32), info,
                          edge_type(cid, pred_id, geodesic)))
    for cid, (T, info, _n, _rmse) in (icp or {}).items():
        edges.append((cid, new_id, T, info, edge_type(cid, pred_id, geodesic)))
    if not accepted and icp and pred_id in icp:
        base_id, base_T_new = pred_id, icp[pred_id][0]
    return base_id, base_T_new, edges


def edge_type(cid: int, pred_id: int, geodesic: Set[int]) -> int:
    """An accepted edge is sequential when it reaches the predecessor or its
    geodesic neighbourhood, else a loop closure."""
    return EDGE_SEQUENTIAL if (cid == pred_id or cid in geodesic) else EDGE_LOOP


def const_position_edge(pred_id: int, new_id: int, dt_pred: float, params):
    """Fallback constant-position edge (graph_manager.cpp:636-655)."""
    info_scale = params["constant_position_information"] / dt_pred
    return (pred_id, new_id, np.eye(4, dtype=np.float32),
            np.eye(6, dtype=np.float32) * info_scale, EDGE_CONST_POSITION)


class Subgraph(NamedTuple):
    """The affected subgraph of pose_relative_to=inaffected, padded to
    power-of-two buckets: global node ids (padded with a fixed node),
    global edge ids and local endpoints (padded with the first edge), and
    the node/edge masks."""

    gi: np.ndarray  # (ncap,) int32
    ge: np.ndarray  # (ecap,) int32
    li: np.ndarray  # (ecap,) int32
    lj: np.ndarray  # (ecap,) int32
    nfix: np.ndarray  # (ncap,) bool, border nodes held fixed
    nact: np.ndarray  # (ncap,) bool
    eact: np.ndarray  # (ecap,) bool
    free_mask: np.ndarray  # (ncap,) bool, the poses that scatter back


def inaffected_subgraph(edge_i: np.ndarray, edge_j: np.ndarray, edge_active: np.ndarray,
                        n_edges: int, watermark: int) -> Optional[Subgraph]:
    """Active edges touching a node at or above the watermark, their nodes,
    and the border (nodes below it) held fixed; None when no edge is
    affected (graph_manager.cpp:889-892, 969-992)."""
    ei, ej = edge_i[:n_edges], edge_j[:n_edges]
    sel = edge_active[:n_edges] & (ei >= 0) & ((ei >= watermark) | (ej >= watermark))
    sub_eids = np.nonzero(sel)[0]
    if sub_eids.size == 0:
        return None
    sei, sej = ei[sub_eids], ej[sub_eids]
    nodes = np.unique(np.concatenate([sei, sej]))
    li = np.searchsorted(nodes, sei).astype(np.int32)
    lj = np.searchsorted(nodes, sej).astype(np.int32)
    n_nodes_sub, n_eids = len(nodes), len(sub_eids)
    ncap = max(32, 1 << (n_nodes_sub - 1).bit_length())
    ecap = max(64, 1 << (n_eids - 1).bit_length())
    n_fix = nodes < watermark
    if not n_fix.any():  # nothing anchors the subgraph: fix its oldest
        n_fix = n_fix.copy()
        n_fix[0] = True
    # pad node slots with a fixed node: every duplicate scatter index then
    # writes the same unchanged pose
    pad_node = nodes[int(np.argmax(n_fix))]
    pad_false_n = np.zeros(ncap - n_nodes_sub, bool)
    return Subgraph(
        gi=np.concatenate([nodes, np.full(ncap - n_nodes_sub, pad_node, nodes.dtype)]
                          ).astype(np.int32),
        ge=np.concatenate([sub_eids, np.full(ecap - n_eids, sub_eids[0], sub_eids.dtype)]
                          ).astype(np.int32),
        li=np.concatenate([li, np.full(ecap - n_eids, li[0], np.int32)]),
        lj=np.concatenate([lj, np.full(ecap - n_eids, lj[0], np.int32)]),
        nfix=np.concatenate([n_fix, ~pad_false_n]),
        nact=np.concatenate([np.ones(n_nodes_sub, bool), pad_false_n]),
        eact=np.concatenate([np.ones(n_eids, bool), np.zeros(ecap - n_eids, bool)]),
        free_mask=np.concatenate([nodes >= watermark, pad_false_n]),
    )


class HostGraph:
    """Adjacency, keyframes, edge types and edge mirrors of the pose graph."""

    def __init__(self, e_cap: int, params, seed: int):
        self.params = params
        self.n_nodes = 0
        self.n_edges = 0
        self.n_loop_edges = 0
        self.n_seq_edges = 0
        self.timestamps: List[float] = []
        self.keyframes: List[int] = [0]
        self.adjacency: Dict[int, Set[int]] = {}
        self.edge_types: List[int] = []
        self.edge_pairs: List[Optional[tuple]] = []
        self.edge_active = np.zeros(e_cap, bool)
        self.edge_i = np.full(e_cap, -1, np.int32)
        self.edge_j = np.full(e_cap, -1, np.int32)
        self.rng = np.random.default_rng(seed)
        self.clear_queue: List[int] = []  # clear_non_keyframes batching

    # ------------------------------------------------------------------
    def select_candidates(self, new_id: int, B: int, appearance=None) -> List[int]:
        """Sequential predecessors + geodesic BFS neighbours (1/depth
        weighted) + appearance hits + random keyframes. appearance(out), when
        given, returns the global retrieval's hits for the candidates so far
        (global_loop_candidates; it is asked only while out holds fewer
        than B)."""
        p = self.params
        out = list(range(new_id - 1, max(-1, new_id - 1 - p["predecessor_candidates"]), -1))
        if new_id >= 1 and len(out) < B:
            start = new_id - 1
            depth_of = {start: 0}
            frontier = [start]
            for d in range(1, p["geodesic_depth"] + 1):
                nxt = []
                for u in frontier:
                    for v in self.adjacency.get(u, ()):
                        if v not in depth_of:
                            depth_of[v] = d
                            nxt.append(v)
                frontier = nxt
            cand = [v for v in depth_of if v not in out and v != new_id and depth_of[v] > 0]
            if cand:
                w = np.asarray([1.0 / depth_of[v] for v in cand])
                w = w / w.sum()
                n_geo = min(p["neighbor_candidates"], len(cand), B - len(out))
                if n_geo > 0:
                    sel = self.rng.choice(len(cand), size=n_geo, replace=False, p=w)
                    out.extend(cand[i] for i in sel)
        if appearance is not None and len(out) < B:
            out.extend(h for h in appearance(out) if h not in out)
        kf_pool = [k for k in self.keyframes if k not in out and k != new_id]
        n_rand = min(len(kf_pool), B - len(out), max(p["min_sampled_candidates"], 0))
        if n_rand > 0:
            sel = self.rng.choice(len(kf_pool), size=n_rand, replace=False)
            out.extend(kf_pool[i] for i in sel)
        return out[:B]

    def frame_slots(self, new_id: int, timestamp: float, B: int, appearance=None):
        """Candidates padded to B (duplicates flagged) and their dt;
        slot 0 holds the predecessor."""
        cand_ids = self.select_candidates(new_id, B, appearance)
        padded = (cand_ids + [cand_ids[0]] * B)[:B]
        dup = ([False] * len(cand_ids) + [True] * (B - len(cand_ids)))[:B]
        dts = [max(abs(timestamp - self.timestamps[c]), 1e-3) for c in padded]
        pred_id = new_id - 1
        if padded[0] != pred_id and pred_id in padded:
            k = padded.index(pred_id)
            padded[0], padded[k] = padded[k], padded[0]
            dup[0], dup[k] = dup[k], dup[0]
            dts[0], dts[k] = dts[k], dts[0]
        return padded, dup, dts

    def reserve_edges(self, B: int) -> int:
        """Reserve B+1 slots (filled at drain time); returns the first."""
        start = self.n_edges
        self.n_edges = start + B + 1
        self.edge_pairs.extend([None] * (B + 1))
        self.edge_types.extend([-1] * (B + 1))
        return start

    def add_edge(self, i: int, j: int, etype: int) -> int:
        """Host record of one edge appended at slot n_edges."""
        e = self.n_edges
        self.n_edges += 1
        self.edge_active[e] = True
        self.edge_i[e], self.edge_j[e] = i, j
        self.adjacency.setdefault(i, set()).add(j)
        self.adjacency.setdefault(j, set()).add(i)
        self.edge_types.append(etype)
        self.edge_pairs.append((i, j))
        if etype == EDGE_LOOP:
            self.n_loop_edges += 1
        elif etype == EDGE_SEQUENTIAL:
            self.n_seq_edges += 1
        return e

    # ------------------------------------------------------------------
    def apply_summary(self, new_id: int, padded: List[int], edge_start: int,
                      s) -> Optional[Tuple[int, int]]:
        """Record one drained frame: edge types, adjacency, keyframes.
        Returns (new_id, fallback edge slot) when the frame fell back to a
        constant-position edge (the retroactive ICP rescue's work), else
        None."""
        pred_id = new_id - 1
        B = len(padded)
        accepted_ids = []
        geodesic = self.geodesic_set(pred_id, self.params["geodesic_depth"])
        for b, cid in enumerate(padded):
            slot = edge_start + b
            self.edge_i[slot] = cid
            self.edge_j[slot] = new_id
            self.edge_pairs[slot] = (cid, new_id)
            if s.accepted[b]:
                etype = edge_type(cid, pred_id, geodesic)
                self.edge_types[slot] = etype
                self.edge_active[slot] = True
                self.adjacency.setdefault(cid, set()).add(new_id)
                self.adjacency.setdefault(new_id, set()).add(cid)
                accepted_ids.append(cid)
                if etype == EDGE_LOOP:
                    self.n_loop_edges += 1
                else:
                    self.n_seq_edges += 1
        fb_slot = edge_start + B
        self.edge_pairs[fb_slot] = (pred_id, new_id)
        self.edge_i[fb_slot] = pred_id
        self.edge_j[fb_slot] = new_id
        if s.fallback_used:
            self.edge_types[fb_slot] = EDGE_CONST_POSITION
            self.edge_active[fb_slot] = True
            self.adjacency.setdefault(pred_id, set()).add(new_id)
            self.adjacency.setdefault(new_id, set()).add(pred_id)
        self.add_keyframe(accepted_ids, pred_id)
        return (new_id, fb_slot) if s.fallback_used else None

    def apply_rescue(self, slot: int) -> None:
        """A retroactive ICP rescue replaced the constant-position edge in
        `slot`: it counts as a sequential edge now."""
        self.edge_types[slot] = EDGE_SEQUENTIAL
        self.n_seq_edges += 1

    def add_keyframe(self, accepted_ids: List[int], pred_id: int) -> None:
        """addKeyframe (graph_manager.cpp:784-809): when no accepted edge
        reaches a keyframe, the predecessor becomes one."""
        if not any(c in self.keyframes for c in accepted_ids):
            if self.keyframes[-1] != pred_id:
                self.keyframes.append(pred_id)

    def non_keyframes_to_clear(self, new_id: int) -> Optional[List[int]]:
        """clear_non_keyframes (graph_manager.cpp:788-802): a node that left
        the predecessor window without becoming a keyframe is queued; every
        16 queued nodes are returned for one batched clear."""
        old = new_id - self.params["predecessor_candidates"] - 1
        if old > 0 and old not in self.keyframes:
            self.clear_queue.append(old)
        if len(self.clear_queue) < 16:
            return None
        out, self.clear_queue = self.clear_queue, []
        return out

    def delete_last(self) -> int:
        """deleteLastFrame's bookkeeping (graph_manager2.cpp:61): deactivate
        the newest node's edges; returns its id. Edge slots and the edge
        counters stay, as in the reference."""
        nid = self.n_nodes - 1
        for e, pair in enumerate(self.edge_pairs):
            if pair is None:
                continue
            i, j = pair
            if i == nid or j == nid:
                self.edge_active[e] = False
                self.adjacency.get(i, set()).discard(j)
                self.adjacency.get(j, set()).discard(i)
        self.n_nodes -= 1
        self.timestamps.pop()
        if self.keyframes and self.keyframes[-1] == nid:
            self.keyframes.pop()
        return nid

    def geodesic_set(self, start: int, depth: int) -> Set[int]:
        seen = {start}
        frontier = [start]
        for _ in range(depth):
            nxt = []
            for u in frontier:
                for v in self.adjacency.get(u, ()):
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        return seen

    def fixation_mask(self, n_cap: int, watermark: int, mapping_enabled: bool) -> np.ndarray:
        """pose_relative_to strategies first / previous / largest_loop /
        inaffected (graph_manager.cpp:911-937); in localization mode every
        node is fixed."""
        strategy = self.params["pose_relative_to"]
        mask = np.zeros(n_cap, bool)
        if strategy == "previous" and self.n_nodes > 1:
            mask[self.n_nodes - 2] = True
        elif strategy == "largest_loop" and self.n_loop_edges > 0:
            loop_nodes = [min(pair) for pair, t in zip(self.edge_pairs, self.edge_types)
                          if t == EDGE_LOOP and pair is not None]
            mask[: (min(loop_nodes) if loop_nodes else 0) + 1] = True
        elif strategy == "inaffected" and 1 < watermark:
            # fix everything already optimized; only nodes added since the
            # last optimize move (graph_manager.cpp:889-892, 969-992)
            mask[: min(watermark, self.n_nodes)] = True
        else:  # "first"
            mask[0] = True
        if not mask[: max(self.n_nodes, 1)].any():
            mask[0] = True
        if not mapping_enabled:
            mask[: self.n_nodes] = True
        return mask
