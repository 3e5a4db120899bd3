"""The benchmark's plain reference of the host decisions
(``slambench/reference/decisions.py``) agrees with the port's
(``graph/host_graph.py``: ``decide_matches``, ``is_redundant``,
``build_edges``, the node-or-drop rule of ``GraphManager._add_frame_host``)
on seeded random comparison results, at ``default_fr1desk``'s
configuration and with the motion gates, the EMM, ``max_connections``,
``keep_good_nodes`` and a 6x6 edge information on; and the port's LM at a
capacity of 4096 nodes ("auto" picks PCG there) reaches the reference's
float64 optimum of a random 64-node graph within that cell's
``pose_excess`` limit.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "slambench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import decisions, pose_graph, se3  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import host_graph  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.compare import CompareSummary  # noqa: E402

torch.set_num_threads(1)
CONFIG = json.loads((BENCH / "configs" / "rgbdslam_default.json").read_text())["params"]
LIMITS = json.loads((BENCH / "limits" / "default_fr1desk.json").read_text())["limits"]
B = CONFIG["tpu_candidate_batch"]
CASES = {
    "default": {},
    "motion_gates": dict(min_translation_meter=0.6, min_rotation_degree=40.0,
                         max_translation_meter=6.0, max_rotation_degree=500.0),
    "emm": dict(observability_threshold=0.5),
    "max_connections": dict(max_connections=2),
    "keep_good_nodes": dict(keep_good_nodes=True, min_keypoints=450),
    "hessian_info": dict(max_connections=3),
}


def _summary(rng, hessian: bool) -> CompareSummary:
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.radians(rng.uniform(0, 30, B))[:, None]
    # a still camera now and then, for the redundancy rule
    xi = np.concatenate([rng.normal(0, 0.08, (B, 3)), axis * ang], 1) * rng.choice([0.05, 1])
    info6 = None
    if hessian:
        a = rng.normal(size=(B, 6, 6))
        info6 = (a @ np.swapaxes(a, 1, 2) + np.eye(6)).astype(np.float32)
        info6[rng.random(B) < 0.2, 0, 0] = np.nan  # unusable: the scalar information
    return CompareSummary(
        transform=se3.exp(xi).astype(np.float32),
        n_inliers=rng.choice([12, 40, 40, 90, 150, 300], B),
        rmse=rng.uniform(0.001, 0.03, B).astype(np.float32),
        ransac_ok=rng.random(B) < rng.choice([0.05, 0.5, 0.9]),
        emm_quality=rng.uniform(0, 1, B).astype(np.float32),
        emm_inlier_frac=rng.uniform(0, 0.6, B).astype(np.float32),
        n_valid_kp=int(rng.integers(100, 600)), info6=info6)


def _graph(rng, new_id: int):
    """A random earlier graph: a chain with a few loop edges."""
    edges = [(k - 1, k) for k in range(1, new_id)]
    edges += [tuple(sorted(rng.choice(new_id, 2, replace=False))) for _ in range(new_id // 3)]
    host = host_graph.HostGraph(4 * len(edges) + 8, {}, 0)
    for i, j in edges:
        host.add_edge(int(i), int(j), host_graph.EDGE_SEQUENTIAL)
    return edges, host


@pytest.mark.parametrize("case", list(CASES))
def test_reference_decisions_equal_the_ports(case):
    params = dict(CONFIG, **CASES[case])
    rng = np.random.default_rng(sorted(CASES).index(case))
    seen = {"node": 0, "drop": 0, "redundant": 0, "loop": 0, "cut": 0}
    for _ in range(300):
        new_id = int(rng.integers(2, 40))
        edges, host = _graph(rng, new_id)
        stamps = list(np.cumsum(rng.uniform(1 / 40, 1 / 20, new_id)))
        stamp = stamps[-1] + rng.uniform(1 / 40, 1 / 20)
        pred = new_id - 1
        cands = [pred] + [int(c) for c in rng.choice(pred, min(pred, B - 1), replace=False)]
        padded = (cands + [cands[0]] * B)[:B]
        cmp = _summary(rng, case == "hessian_info")

        decisions_, accepted = host_graph.decide_matches(padded, cmp, stamp, stamps, pred, params)
        redundant = host_graph.is_redundant(padded, accepted, cmp, pred,
                                            max(stamp - stamps[pred], 1e-3), params)
        base_id, base_T, port_edges = host_graph.build_edges(
            padded, accepted, cmp, pred, new_id, host.geodesic_set(pred, params["geodesic_depth"]))
        node = not redundant and bool(port_edges or params["keep_all_nodes"] or (
            params["keep_good_nodes"] and cmp.n_valid_kp > params["min_keypoints"]))

        ref = decisions.decide(padded, cmp._asdict(), stamp, stamps, new_id, params, edges,
                               cmp.n_valid_kp)
        assert ref["accepted"] == sorted(accepted)
        assert ref["redundant"] == redundant and ref["node"] == node
        assert ref["base"][0] == base_id
        np.testing.assert_allclose(ref["base"][1], base_T, atol=1e-6)
        got = sorted(port_edges, key=lambda e: e[0])
        want = sorted(ref["edges"], key=lambda e: e[0])
        assert [(i, j, t) for i, j, _, _, t in got] == [(i, j, t) for i, j, _, _, t in want]
        for (_, _, Tp, Ip, _), (_, _, Tr, Ir, _) in zip(got, want):
            np.testing.assert_allclose(Tp, Tr, atol=1e-6)
            np.testing.assert_allclose(Ip, Ir, rtol=1e-5)
        seen["node" if node else "drop"] += 1
        seen["redundant"] += redundant
        seen["loop"] += any(e[4] == decisions.LOOP for e in want)
        seen["cut"] += len([d for d in decisions_ if d.accepted]) > len(accepted)
    # the seeded cases reach each branch their settings open
    assert seen["node"] > 30 and seen["drop"] > 10 and seen["loop"] > 10, seen
    assert (seen["redundant"] > 10) == (case == "motion_gates"), seen
    assert (seen["cut"] > 10) == (params["max_connections"] > 0), seen


def test_pcg_at_capacity_4096_reaches_the_reference_optimum():
    from rgbdslam_v2_tpu_torch.optim.pose_graph import (make_graph_state, optimize,
                                                         resolve_solver)

    rng = np.random.default_rng(5)
    n, cap = 64, CONFIG["tpu_max_nodes"]
    assert resolve_solver(CONFIG["backend_solver"], cap) == "pcg"
    ang = 2 * np.pi * np.arange(n) / n
    gt = np.stack([se3.exp(np.array([0, 0, 0, 0.1 * np.sin(3 * a), 0, a])) for a in ang])
    gt[:, :3, 3] = np.stack([2 + 1.4 * np.cos(ang), 1.5 + 1.2 * np.sin(ang), 0.2 * ang], -1)
    pairs = [(k - d, k) for k in range(1, n) for d in (1, 2, 3) if k - d >= 0]
    pairs += [tuple(sorted(rng.choice(n, 2, replace=False))) for _ in range(24)]
    I, J = np.array(pairs).T
    # the program's scale of information, inliers over the squared RMSE,
    # and errors within it, as the cells' edges have them: the Huber
    # kernel rarely engages (where most edges sit above its threshold,
    # dense and PCG alike stop ~1% above the Huber optimum, since LM's
    # accept test reads the plain chi2)
    w = rng.uniform(20, 300, len(I)) / rng.uniform(0.005, 0.03, len(I)) ** 2
    info = np.eye(6)[None] * w[:, None, None]
    Z = se3.inv(gt[I]) @ gt[J] @ se3.exp(rng.normal(0, 0.3, (len(I), 6)) / np.sqrt(w)[:, None])
    init = gt @ se3.exp(rng.normal(0, 0.02, (n, 6)))
    init[0] = gt[0]
    g = make_graph_state(cap, 4 * len(I), device="cpu")
    g.poses[:n] = torch.tensor(init, dtype=torch.float32)
    g.node_active[:n] = True
    g.node_fixed[0] = True
    E = len(I)
    g.edge_i[:E] = torch.tensor(I, dtype=torch.int32)
    g.edge_j[:E] = torch.tensor(J, dtype=torch.int32)
    g.edge_meas[:E] = torch.tensor(Z, dtype=torch.float32)
    g.edge_info[:E] = torch.tensor(info, dtype=torch.float32)
    g.edge_active[:E] = True
    # the protocol's level-1 call (GraphManager.optimize's defaults)
    optimize(g, iterations=2 * CONFIG["optimizer_iterations"], huber_delta=CONFIG["huber_delta"],
             pcg_iters=64, solver=CONFIG["backend_solver"], n_nodes=n, n_edges=E)
    graph = {"edge_i": I, "edge_j": J, "edge_meas": Z.astype(np.float32),
             "edge_info": info.astype(np.float32), "edge_active": np.ones(E, bool)}
    fixed = np.zeros(n, bool)
    fixed[0] = True
    ex, _ = pose_graph.excess(g.poses[:n].double().numpy(), graph, fixed, CONFIG["huber_delta"])
    assert 0 <= ex < LIMITS["pose_excess"], ex
