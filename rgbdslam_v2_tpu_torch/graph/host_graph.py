"""Host-side graph bookkeeping (numpy and Python only, no tensors).

Port of the bookkeeping half of ``rgbdslam_v2_tpu/graph/manager.py``:
``select_candidates``, ``_frame_slots``, the per-frame body of
``_drain_batch``, ``_geodesic_set`` and ``_fixation_mask``, plus the host
mirrors of edge metadata. ``graph/manager.py`` holds the device half.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

EDGE_SEQUENTIAL = 0
EDGE_LOOP = 1
EDGE_CONST_POSITION = 3  # the reference's numbering (2 = odometry)


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

    # ------------------------------------------------------------------
    def select_candidates(self, new_id: int, B: int) -> List[int]:
        """Sequential predecessors + geodesic BFS neighbours (1/depth
        weighted) + random keyframes."""
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
        kf_pool = [k for k in self.keyframes if k not in out and k != new_id]
        n_rand = min(len(kf_pool), B - len(out), max(p["min_sampled_candidates"], 0))
        if n_rand > 0:
            sel = self.rng.choice(len(kf_pool), size=n_rand, replace=False)
            out.extend(kf_pool[i] for i in sel)
        return out[:B]

    def frame_slots(self, new_id: int, timestamp: float, B: int):
        """Candidates padded to B (duplicates flagged) and their dt;
        slot 0 holds the predecessor."""
        cand_ids = self.select_candidates(new_id, B)
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
    def apply_summary(self, new_id: int, padded: List[int], edge_start: int, s) -> None:
        """Record one drained frame: edge types, adjacency, keyframes."""
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
                etype = EDGE_SEQUENTIAL if (cid == pred_id or cid in geodesic) else EDGE_LOOP
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
        # keyframe bookkeeping (addKeyframe, graph_manager.cpp:784-809)
        if not any(c in self.keyframes for c in accepted_ids):
            if self.keyframes[-1] != pred_id:
                self.keyframes.append(pred_id)

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

    def fixation_mask(self, n_cap: int) -> np.ndarray:
        """pose_relative_to strategies first / previous / largest_loop
        (graph_manager.cpp:911-937)."""
        strategy = self.params["pose_relative_to"]
        mask = np.zeros(n_cap, bool)
        if strategy == "previous" and self.n_nodes > 1:
            mask[self.n_nodes - 2] = True
        elif strategy == "largest_loop" and self.n_loop_edges > 0:
            loop_nodes = [min(pair) for pair, t in zip(self.edge_pairs, self.edge_types)
                          if t == EDGE_LOOP and pair is not None]
            mask[: (min(loop_nodes) if loop_nodes else 0) + 1] = True
        elif strategy == "inaffected":
            raise NotImplementedError("pose_relative_to='inaffected'")
        else:  # "first"
            mask[0] = True
        if not mask[: max(self.n_nodes, 1)].any():
            mask[0] = True
        return mask
