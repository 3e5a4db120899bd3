"""Whether the timed path's answers were right: the program's state read
back (``snapshot``) and judged against the plain reference (``judge``).

The answers of a window, each judged on a sample drawn from the seed, of
every sequence the window touched:

* every frame handed to the program becomes a node (keep-all): the
  nodes the device graph holds as active, against the frames fed
  (``frames_missing``, exact, limit 0);
* every node holds the keypoints of its frame: the reference takes the
  raw frame the benchmark rendered, sends it through the configuration's
  wire and extracts its keypoints plainly (``reference/wire.py``,
  ``reference/features.py``); against the node's stored keypoints, the
  share that one side has and the other has not (``kp_missing``, the
  largest over the judged frames) and, of those both have, the
  descriptors' gap (``desc_gap``, the 90th percentile; the share of bits
  that differ, or the L2 distance of float descriptors);
* every visual edge is a registration of its two nodes: the reference
  matches the two nodes' stored keypoints again, gates the matches at
  the program's transform with the full covariance of both points and
  computes the edge's information (inliers over their squared RMS
  Mahalanobis distance); the gap to the information the program stored,
  over the larger of the two, is ``edge_info_gap`` (the 90th percentile
  over the edges). One more weighted refit of the inliers moves the
  transform by ``refit_gap_mm`` (``reference/registration.refit_gap``;
  the 2nd percentile over the edges): the configured 4 refits leave most
  edges short of their fixed point, where one more refit moves them by
  1-2 mm, but some converge, and there the program's transform has to be
  the float64 fit of its own inliers to a micrometre; a transform moved
  after its fit, or fitted by wrong arithmetic, is not;
* every sequence that ended in the window holds the optimum of its final
  pose graph: the Huber cost of its poses against the float64 optimum of
  the same graph (``reference/pose_graph.py``), as a relative excess
  (``pose_excess``, the largest over the sequences).

The registrations are judged from the program's transform: RANSAC draws
its hypotheses at random on the card, and its refits need not reach a
fixed point in the configured 4 rounds, so no second run gives the same
transform. With ``control`` the same numbers are also read for the
reference itself computed in bfloat16 in the program's place (the
control, which has to fail).
"""
from __future__ import annotations

import numpy as np

from reference import features, pose_graph, registration, wire
from reference.precision import bf16, bf16_t

EDGE_QUANTILE = 0.9  # of the edges' information gaps and the descriptors' gaps
# the share of edges below which the smallest refit gaps are read: 8-23%
# of the edges are fixed points of their refinement in sound runs, so the
# 2nd percentile lands on one of them with every seed's share seen
REFIT_QUANTILE = 0.02
# host_graph.EDGE_SEQUENTIAL, EDGE_LOOP: edges of an accepted registration
# (a rejected slot holds -1, a constant-position edge 3)
VISUAL = (0, 1)


def _rows(store, nodes, names) -> list:
    import torch

    idx = torch.as_tensor(nodes, dtype=torch.long, device=store.xyz.device)
    return [getattr(store, k).index_select(0, idx).float().cpu().numpy()
            if k == "desc" else getattr(store, k).index_select(0, idx).cpu().numpy()
            for k in names]


def snapshot(mgr, n_fed: int, finished: bool, rng: np.random.Generator, n_edges: int,
             n_frames: int, frame_of) -> dict:
    """The program's state of one sequence as the judge needs it, read
    from a drained GraphManager (or a MultiSequenceSlam sequence): active
    node count, the edges, the poses where the sequence ended, the
    keypoints of the nodes of `n_edges` visual edges drawn with rng, and
    `n_frames` nodes drawn with rng with their stored keypoints and their
    raw frames (frame_of(node) -> (rgb u8, depth u16); node n is the
    sequence's n-th frame)."""
    g, store = mgr.graph, mgr.store
    n, ne = mgr.n_nodes, mgr.n_edges
    types = np.asarray(mgr.host.edge_types[:ne])
    vis = np.nonzero(np.isin(types, VISUAL))[0]
    pick = np.sort(rng.choice(vis, min(n_edges, len(vis)), replace=False)) if len(vis) else vis
    graph = {k: getattr(g, k)[:ne].cpu().numpy() for k in
             ("edge_i", "edge_j", "edge_meas", "edge_info", "edge_active")}
    nodes = sorted(set(graph["edge_i"][pick].tolist()) | set(graph["edge_j"][pick].tolist()))
    feats = {}
    if nodes:
        xyz, desc, valid = _rows(store, nodes, ("xyz", "desc", "kp_valid"))
        feats = {nid: {"xyz": xyz[k], "desc": desc[k], "valid": valid[k]}
                 for k, nid in enumerate(nodes)}
    frames = []
    judged = np.sort(rng.choice(min(n, n_fed), min(n_frames, n, n_fed), replace=False))
    if len(judged):
        uv, xyz, desc, valid = _rows(store, judged.tolist(), ("uv", "xyz", "desc", "kp_valid"))
        for k, nid in enumerate(judged.tolist()):
            rgb, d16 = frame_of(nid)
            frames.append({"rgb": rgb, "d16": d16, "kp": {"uv": uv[k], "xyz": xyz[k],
                                                          "desc": desc[k], "valid": valid[k]}})
    return {
        "n_fed": int(n_fed), "nodes": int(g.node_active.sum()), "finished": bool(finished),
        "graph": graph if finished else None,
        "poses": g.poses[:n].cpu().numpy() if finished else None,
        "edges": [(int(graph["edge_i"][e]), int(graph["edge_j"][e]), graph["edge_meas"][e],
                   float(graph["edge_info"][e][0, 0])) for e in pick],
        "feats": feats, "frames": frames,
    }


def registration_cfg(config: dict) -> dict:
    p, cam = config["params"], config["camera"]
    return {"max_matches": p["max_matches"], "nn_distance_ratio": p["nn_distance_ratio"],
            "binary": config["descriptor"] == "binary", "fx": cam["fx"], "fy": cam["fy"],
            "sigma_depth": p["sigma_depth"], "ransac_iterations": p["ransac_iterations"],
            "sample_candidates": p["sample_candidates"],
            "max_dist_for_inliers": p["max_dist_for_inliers"],
            "refine_iterations": p["refine_iterations"]}


def info_gap(a: float, b: float) -> float:
    """|a - b| over the larger, 0 where both are 0."""
    return abs(a - b) / max(a, b) if max(a, b) > 0 else 0.0


class _Readings:
    """The per-item readings of one side (the program, or the control)."""

    def __init__(self):
        self.info, self.refit, self.missing, self.desc, self.xyz, self.excess = ([] for _ in
                                                                                 range(6))

    def numbers(self, prefix: str = "") -> dict:
        out = {}
        if self.info:
            out["edge_info_gap"] = float(np.quantile(self.info, EDGE_QUANTILE, method="higher"))
            out["refit_gap_mm"] = 1e3 * float(np.quantile(self.refit, REFIT_QUANTILE))
        if self.missing:
            out["kp_missing"] = float(max(self.missing))
            desc = np.concatenate(self.desc)
            out["desc_gap"] = (float(np.quantile(desc, EDGE_QUANTILE, method="higher"))
                               if len(desc) else 1.0)
        if self.excess:
            out["pose_excess"] = float(max(self.excess))
        # a number that is not finite (no edge keeps 3 inliers) reads as
        # missing, which no limit passes
        return {prefix + k: (v if np.isfinite(v) else None) for k, v in out.items()}

    def details(self, prefix: str = "") -> dict:
        """What the compared numbers rest on, reported beside them."""
        out = {}
        if self.info:
            out.update(edges_judged=len(self.info),
                       edge_info_gap_median=float(np.median(self.info)),
                       refit_gap_mm_median=1e3 * float(np.median(self.refit)),
                       refit_converged=float(np.mean(np.asarray(self.refit) < 1e-6)))
        if self.missing:
            xyz = np.concatenate(self.xyz)
            out.update(frames_judged=len(self.missing),
                       xyz_gap_mm=1e3 * float(xyz.max(initial=0.0)))
        if self.excess:
            out["sequences_judged"] = len(self.excess)
        return {prefix + k: (v if np.isfinite(v) else None) for k, v in out.items()}


def judge(snapshots: list, config: dict, seed: int, control: bool = False,
          device: str = "cpu") -> dict:
    """The numbers compared ({name: value}) and beside them what they rest
    on; with control also {"control." + name: value} for the reference
    computed in bfloat16. The reference's extraction runs on `device`."""
    cfg = registration_cfg(config)
    binary = config["descriptor"] == "binary"
    delta = config["params"]["huber_delta"]
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    prog, ctl, missing = _Readings(), _Readings(), 0
    for s in snapshots:
        missing += s["n_fed"] - s["nodes"]
        for fr in s["frames"]:
            gray8, depth = wire.frame(fr["rgb"], fr["d16"], config["params"])
            ref = features.extract(gray8, depth, config, device=device)
            c = features.compare(fr["kp"], ref, binary)
            prog.missing.append(c["missing"])
            prog.desc.append(c["desc"])
            prog.xyz.append(c["xyz"])
            if control:
                c = features.compare(features.extract(gray8, depth, config, device=device,
                                                      rnd=bf16_t), ref, binary)
                ctl.missing.append(c["missing"])
                ctl.desc.append(c["desc"])
                ctl.xyz.append(c["xyz"])
        for i, j, Z, info in s["edges"]:
            new, cand = s["feats"][j], s["feats"][i]
            Z = Z.astype(np.float64)
            src, dst, _ = registration.matched_points(new, cand, cfg)
            ref = registration.edge_information(Z, src, dst, cfg)
            prog.info.append(info_gap(info, ref))
            prog.refit.append(registration.refit_gap(Z, src, dst, cfg))
            if control:
                T_c = registration.register_nodes(new, cand, cfg, rng, rnd=bf16)
                info_c = registration.edge_information(T_c, src, dst, cfg, rnd=bf16)
                ref_c = registration.edge_information(T_c, src, dst, cfg)
                ctl.info.append(info_gap(info_c, ref_c))
                ctl.refit.append(registration.refit_gap(T_c, src, dst, cfg))
        if s["finished"]:
            fixed = np.zeros(len(s["poses"]), bool)
            fixed[0] = True  # the protocol's pose_relative_to=first
            poses = s["poses"].astype(np.float64)
            prog.excess.append(pose_graph.excess(poses, s["graph"], fixed, delta)[0])
            if control:
                ctl.excess.append(pose_graph.excess(poses, s["graph"], fixed, delta,
                                                    rnd=bf16)[0])
    out = {"frames_missing": missing, **prog.numbers(), **prog.details()}
    if control:
        out.update(ctl.numbers("control."), **ctl.details("control."))
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited number present and
    within its limit (limits: the cell's slambench/limits/<cell>.json)."""
    rows = [(k, numbers.get(k), lim) for k, lim in limits["limits"].items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
