"""The port's parallel/slam_multi.py: the twins of the JAX package's four
tests (tests/test_slam_multi.py), on JAX-rendered 160x120 orbits whose
wires the JAX compact_frame encodes, fed to both packages.

* Sequence i of MultiSequenceSlam against the port's single GraphManager
  with tpu_seed = seed0 + i, no adaptive FAST ladder and no online
  optimize of its own, fed the same wires with add_frame (with and
  without the slam-multi CLI's online optimizes, called on both at the same
  frames): the same candidate slots, edge mirrors, edge types and
  keyframes; poses bit for bit before the final optimize and within 1e-5
  after optimize(iterations=10).
* Against the JAX MultiSequenceSlam on the same wires (ROADMAP F25): per
  sequence the same accepted edges and protocol L4 within 1e-4 m of the
  JAX package's, and L4 < 0.05 m in both (the JAX test's bound).
* A 2-shard CPU mesh equals no mesh bit for bit; the stacks are written
  in place through every sequence's views.
* A poisoned consecutive edge is pruned and replaced by a constant-position
  edge.
* The UNSUPPORTED matrix: the JAX package's names and neutral values,
  each warned about and forced; others pass through.
"""
import logging

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import compact_frame as jcompact  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld  # noqa: E402
from rgbdslam_v2_tpu.parallel.slam_multi import MultiSequenceSlam as JMulti  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager  # noqa: E402
from rgbdslam_v2_tpu_torch.parallel import candidate_mesh  # noqa: E402
from rgbdslam_v2_tpu_torch.parallel.slam_multi import MultiSequenceSlam  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)


def _params(cls, **over):
    """The JAX test's parameters."""
    base = dict(max_keypoints=128, tpu_max_nodes=32, tpu_max_edges=512, tpu_candidate_batch=4,
                ransac_iterations=64, keep_all_nodes=True, observability_threshold=0.5,
                min_matches=12, optimizer_skip_step=1000, tpu_drain_interval=4)
    base.update(over)
    return cls(base)


def _sequences(n_seq, n_frames, seed0):
    """n_seq JAX-rendered orbits around differently seeded worlds: (gt
    poses, wires (T, L) from the JAX compact_frame)."""
    out = []
    for s in range(n_seq):
        world = JWorld.create(seed=seed0 + s, texture_size=256, cam=JIntrinsics(*CAM))
        traj = world.orbit_trajectory(n_frames, seed=seed0 + s)
        wires = []
        for T in traj:
            rgb_f, depth = world.render(T)
            wires.append(jcompact((np.asarray(rgb_f) * 255).astype(np.uint8), np.asarray(depth),
                                  2))
        out.append((np.asarray(traj), np.stack(wires)))
    return out


@pytest.fixture(scope="module")
def pair():
    return _sequences(2, 8, seed0=3)


@pytest.fixture(scope="module")
def quad():
    return _sequences(4, 10, seed0=10)


def _feed(ms, seqs, gt0=False):
    T = len(seqs[0][1])
    for k in range(T):
        ms.add_frames(np.stack([w[k] for _, w in seqs]), np.full(len(seqs), k / 30.0),
                      gt_poses=np.stack([t[0] for t, _ in seqs]) if gt0 and k == 0 else None)


@pytest.mark.parametrize("skip", [1000, 3])
def test_multi_matches_single_manager(pair, skip):
    """skip: optimizer_skip_step, which add_frames ignores; with 3 the
    caller optimizes every 3 frames, as the slam-multi CLI does."""
    p = _params(ParameterServer, tpu_seed=0, optimizer_skip_step=skip)
    ms = MultiSequenceSlam(Intrinsics(*CAM), 2, params=p, device="cpu")
    T = len(pair[0][1])
    for k in range(T):
        ms.add_frames(np.stack([w[k] for _, w in pair]), np.full(2, k / 30.0))
        if (k + 1) % skip == 0:
            assert np.all(np.isnan(ms.optimize(iterations=p["online_optimizer_iterations"],
                                               blocking=False)))
    ms._drain()
    before = ms.trajectories()
    chi2 = ms.optimize(iterations=10)
    after = ms.trajectories()
    assert np.all(np.isfinite(chi2))
    for i in (0, 1):
        # a single manager without the ladder and the online optimize
        mgr = GraphManager(Intrinsics(*CAM), _params(ParameterServer, tpu_seed=i,
                                                     adjuster_max_iterations=0), device="cpu")
        for k in range(T):
            mgr.add_frame(None, None, k / 30.0, compact=pair[i][1][k])
            if (k + 1) % skip == 0:
                mgr.optimize(iterations=p["online_optimizer_iterations"], blocking=False,
                             pcg_iters=64)
        mgr._drain_pending()
        h, sh = mgr.host, ms.seq[i].host
        n = mgr.n_edges
        assert sh.n_edges == n and n == 7 * 5
        for name in ("edge_active", "edge_i", "edge_j"):
            np.testing.assert_array_equal(getattr(sh, name)[:n], getattr(h, name)[:n])
        assert sh.edge_types == h.edge_types and sh.keyframes == h.keyframes
        assert sh.adjacency == h.adjacency
        np.testing.assert_array_equal(before[i], mgr.poses())
        mgr.optimize(iterations=10)
        np.testing.assert_allclose(after[i], mgr.poses(), rtol=0, atol=1e-5)


# the quad's settings beside the JAX test's: an optimize cadence and a
# descriptor family, both of which the JAX MultiSequenceSlam ignores in
# add_frames and in its default extractor (ORB)
QUAD = dict(optimizer_skip_step=3, feature_extractor_type="BRISK")
# protocol L4 against the JAX package, per sequence: sequence 1's RANSAC
# draws (ROADMAP F1) reach other consensus sets on 7 of its 30 accepted
# edges (4e-3-4.1e-2 m apart), which moves its L4 by 1.07e-3 m; the other
# sequences agree within 2e-7 m
L4_TOL, L4_TOL_AGREEING = 1.1e-3, 1e-5


@pytest.fixture(scope="module")
def quad_runs(quad):
    """The 4 sequences through the JAX and the port's MultiSequenceSlam
    (no mesh) and the 5-level protocol: (levels, ATE, statistics)."""
    gt_stamps = [list(np.arange(10) / 30.0)] * 4
    gt_xyz = [t[:, :3, 3] for t, _ in quad]
    out = {}
    for name, cls, params, kw in (("jax", JMulti, JParams, {}),
                                  ("torch", MultiSequenceSlam, ParameterServer,
                                   dict(device="cpu"))):
        ms = cls(JIntrinsics(*CAM) if name == "jax" else Intrinsics(*CAM), 4,
                 params=_params(params, **QUAD), **kw)
        _feed(ms, quad, gt0=True)
        levels, ate = ms.evaluation_protocol(gt_stamps=gt_stamps, gt_xyz=gt_xyz)
        out[name] = (levels, ate, ms.statistics())
    return out


def test_multi_against_jax(quad_runs):
    """F25: the port's MultiSequenceSlam computes what the JAX package's
    does (no online optimize inside add_frames, the ORB extractor): per
    sequence the same accepted edges, and protocol L4 within L4_TOL, three
    sequences within L4_TOL_AGREEING."""
    jl, jate, jst = quad_runs["jax"]
    tl, tate, tst = quad_runs["torch"]
    assert set(tl) == set(jl) == {0, 1, 2, 3, 4}
    assert tl[4].shape == jl[4].shape == (4, 10, 4, 4)
    for ate in (jate, tate):
        assert np.all(np.isfinite(ate[4])) and float(np.max(ate[4])) < 0.05, ate
    assert [sorted(s) for s in tst] == [sorted(s) for s in jst]
    for js, ts in zip(jst, tst):
        assert (ts["sequential_edges"], ts["loop_edges"]) == (js["sequential_edges"],
                                                              js["loop_edges"]), (js, ts)
        assert ts["nodes"] == 10 and ts["active_edges"] >= 9
    diff = np.abs(tate[4] - jate[4])
    assert diff.max() <= L4_TOL and np.sort(diff)[2] <= L4_TOL_AGREEING, (tate[4], jate[4])


def test_mesh_equals_no_mesh(quad, quad_runs):
    ms = MultiSequenceSlam(Intrinsics(*CAM), 4, params=_params(ParameterServer, **QUAD),
                           mesh=candidate_mesh(2, platform="cpu"))
    assert [len(sh.seqs) for sh in ms.shards] == [2, 2]
    _feed(ms, quad, gt0=True)
    # the stacks hold what every sequence's views wrote
    for sh in ms.shards:
        for k, sq in enumerate(sh.seqs):
            assert sq.graph.poses.data_ptr() == sh.graph.poses[k].data_ptr()
            assert sq.store.desc.data_ptr() == sh.store.desc[k].data_ptr()
    gt_stamps = [list(np.arange(10) / 30.0)] * 4
    levels, ate = ms.evaluation_protocol(gt_stamps=gt_stamps,
                                         gt_xyz=[t[:, :3, 3] for t, _ in quad])
    ref_levels, ref_ate, ref_stats = quad_runs["torch"]
    for lv in range(5):
        np.testing.assert_array_equal(levels[lv], ref_levels[lv])
        np.testing.assert_array_equal(ate[lv], ref_ate[lv])
    assert ms.statistics() == ref_stats


def test_prune_replaces_consecutive_edges(pair):
    ms = MultiSequenceSlam(Intrinsics(*CAM), 1, params=_params(ParameterServer), device="cpu")
    for k in range(6):
        ms.add_frames(pair[0][1][k][None], k / 30.0)
    ms._drain()
    sq = ms.seq[0]
    h = sq.host
    slots = [e for e in range(h.n_edges) if h.edge_active[e] and h.edge_pairs[e] is not None
             and abs(h.edge_pairs[e][0] - h.edge_pairs[e][1]) == 1]
    e = slots[len(slots) // 2]
    bad = torch.eye(4)
    bad[:3, 3] = 5.0
    sq.graph.edge_meas[e] = bad  # a view: the stack sees it
    assert torch.equal(ms.shards[0].graph.edge_meas[0, e], bad)
    before = h.n_edges
    counts = ms.prune_edges_above(5.0)
    assert counts[0] >= 1
    assert not h.edge_active[e]
    assert h.n_edges == before + counts[0]  # replacements appended
    assert h.edge_types[before:] == [EDGE_CONST_POSITION] * int(counts[0])
    ms.optimize(iterations=8)
    assert np.all(np.isfinite(ms.trajectories()))


def test_feature_matrix_is_jax_s(caplog):
    requested = dict(global_loop_candidates=3, use_robot_odom=True, use_robot_odom_only=True,
                     tpu_wire_delta=True, pose_relative_to="inaffected")
    assert [n for n, _, _ in MultiSequenceSlam.UNSUPPORTED] == [n for n, _, _ in JMulti.UNSUPPORTED]
    assert [v for _, _, v in MultiSequenceSlam.UNSUPPORTED] == [v for _, _, v in JMulti.UNSUPPORTED]
    assert {n for n, _, _ in MultiSequenceSlam.UNSUPPORTED} == set(requested)
    with caplog.at_level(logging.WARNING):
        ms = MultiSequenceSlam(Intrinsics(*CAM), 1, params=_params(ParameterServer, **requested),
                               device="cpu")
    for name, _req, neutral in MultiSequenceSlam.UNSUPPORTED:
        assert ms.params[name] == neutral, name
        assert any(name in r.message for r in caplog.records), name
    assert ms.params["max_keypoints"] == 128
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        MultiSequenceSlam(Intrinsics(*CAM), 1, params=_params(ParameterServer), device="cpu")
    assert not [r for r in caplog.records if "does not support" in r.message]


def test_capacity_and_shape_errors(pair):
    ms = MultiSequenceSlam(Intrinsics(*CAM), 2, params=_params(
        ParameterServer, tpu_max_edges=12), device="cpu")
    with pytest.raises(ValueError, match="3 wires for 2 sequences"):
        ms.add_frames(np.stack([pair[0][1][0]] * 3), 0.0)
    ms.add_frames(np.stack([pair[0][1][0], pair[1][1][0]]), 0.0)
    ms.add_frames(np.stack([pair[0][1][1], pair[1][1][1]]), 1 / 30.0)  # slots 0..4
    ms.add_frames(np.stack([pair[0][1][2], pair[1][1][2]]), 2 / 30.0)  # slots 5..9
    with pytest.raises(RuntimeError, match="edge capacity"):
        ms.add_frames(np.stack([pair[0][1][3], pair[1][1][3]]), 3 / 30.0)
    with pytest.raises(ValueError, match="3 sequences not divisible by 2 devices"):
        MultiSequenceSlam(Intrinsics(*CAM), 3, params=_params(ParameterServer),
                          mesh=candidate_mesh(2, platform="cpu"))
