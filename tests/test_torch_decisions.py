"""Port parity for the host-decision path (keep_all_nodes=False) with
injected comparisons: both managers' comparison step is replaced for the
test by one that returns the same numpy-made results (transforms from the
ground truth with seeded noise, seeded inlier counts, RMSE, RANSAC and EMM
verdicts), so everything downstream of the comparison can be held to the
JAX package exactly. Keypoints come from the real extractors (bitwise equal
in both packages), so the keypoint-count decisions are exercised too.

40 frames of the JAX-rendered 160x120 sequence, one case a decision rule:
max_connections, the redundancy drop (min_translation_meter/
min_rotation_degree), motion_insane, keep_good_nodes on and off with an
unmatched frame 1 (constant-position fallback / first-node replacement),
clear_non_keyframes. Frames 7 and 15 are unmatched in every case.

Asserted exactly: add_frame's return, last_decisions (cand_id, accepted,
reason, n_inliers), edge pairs and types, keyframes, n_nodes, timestamps,
keypoint validity; poses to atol 1e-5 (float32 online optimizes, other
summation order). Then toggle_mapping(False) gives the same
localization_pose (atol 1e-5) and delete_last_frame the same graph.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph import manager as jmanager  # noqa: E402
from rgbdslam_v2_tpu.graph.compare import CompareResult as JCompareResult  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import manager as tmanager  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.compare import CompareResult  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 40
N_MAP = 36  # mapped frames; the rest localize
UNMATCHED = (7, 15)
BASE = dict(max_keypoints=256, tpu_max_nodes=64, tpu_max_edges=512, tpu_candidate_batch=6,
            min_matches=12, keep_all_nodes=False)
CASES = {
    "max_connections": dict(max_connections=2, observability_threshold=0.5),
    "redundancy": dict(min_translation_meter=1.4, min_rotation_degree=58.0),
    "motion_insane": dict(max_translation_meter=3.0),
    "keep_good_nodes": dict(keep_good_nodes=True),
    "first_node_replacement": dict(keep_good_nodes=False),
    "clear_non_keyframes": dict(clear_non_keyframes=True),
}


@pytest.fixture(scope="module")
def sequence():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=2)
    return np.asarray(poses), rgbs, depths


def _exp(xi):
    return np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _results(gt, frame, cand_frames, case):
    """Numpy comparison results of `frame` against candidate frames."""
    rng = np.random.default_rng([len(case), frame])
    B = len(cand_frames)
    T = np.linalg.inv(gt[cand_frames]) @ gt[frame] @ _exp(
        np.concatenate([rng.normal(0, 0.002, (B, 3)), rng.normal(0, 0.01, (B, 3))], 1))
    if case == "motion_insane":
        T[rng.uniform(size=B) < 0.3, :3, 3] += 0.1  # a 3 m/s jump
    ok = rng.uniform(size=B) > 0.15
    if frame in UNMATCHED or (frame == 1 and case in ("keep_good_nodes",
                                                       "first_node_replacement")):
        ok[:] = False
    return dict(transform=T.astype(np.float32), n_inliers=rng.integers(14, 200, B).astype(np.int32),
                rmse=rng.uniform(0.004, 0.03, B).astype(np.float32), ransac_ok=ok,
                emm_quality=rng.uniform(0.2, 1.0, B).astype(np.float32),
                emm_inlier_frac=rng.uniform(0.1, 1.0, B).astype(np.float32))


def _inject(jm, tm, gt, case, clock):
    """Replace both comparison steps; clock["frame"] names the new frame."""
    def frames_of(mgr, cand_idx):
        return [int(round(mgr.timestamps[int(c)] * 30)) for c in np.asarray(cand_idx)]

    def jax_compare(kp, depth_small, cand_idx, key):
        r = _results(gt, clock["frame"], frames_of(jm, cand_idx), case)
        B = len(r["rmse"])
        return JCompareResult(n_matches=np.zeros(B, np.int32), emm_all=np.zeros(B, np.int32),
                              info6=np.zeros((B, 6, 6), np.float32), **r)

    def port_compare(kp, depth_small, cand_idx):
        r = _results(gt, clock["frame"], frames_of(tm, cand_idx.cpu()), case)
        return CompareResult(**{k: torch.from_numpy(v) for k, v in r.items()})

    jm._compare_dispatch = jax_compare
    tm._compare_dispatch = port_compare


def _decisions(mgr):
    return [(d.cand_id, d.accepted, d.reason, d.n_inliers) for d in mgr.last_decisions]


def _assert_same_graph(jm, tm):
    assert tm.n_nodes == jm.n_nodes and tm.n_edges == jm.n_edges
    assert tm.host.edge_pairs == jm.edge_pairs
    assert tm.host.edge_types == jm.edge_types
    assert tm.keyframes == jm.keyframes
    assert tm.timestamps == jm.timestamps
    np.testing.assert_array_equal(tm.host.edge_active, jm.edge_active_host)
    np.testing.assert_array_equal(tm.graph.edge_active.numpy(), np.asarray(jm.graph.edge_active))
    np.testing.assert_array_equal(tm.graph.node_active.numpy(), np.asarray(jm.graph.node_active))
    np.testing.assert_array_equal(tm.store.kp_valid.numpy(), np.asarray(jm.store.kp_valid))
    np.testing.assert_allclose(tm.poses(), jm.poses(), atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_host_decisions_match_jax(sequence, case):
    gt, rgbs, depths = sequence
    params = dict(BASE, **CASES[case])
    jm = jmanager.GraphManager(JIntrinsics(*CAM), JParams(dict(params)))
    tm = tmanager.GraphManager(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    clock = {}
    _inject(jm, tm, gt, case, clock)
    took, reasons = [], set()
    for f in range(N_MAP):
        clock["frame"] = f
        g0 = gt[0] if f == 0 else None
        a = jm.add_frame(rgbs[f], depths[f], f / 30.0, g0)
        b = tm.add_frame(rgbs[f], depths[f], f / 30.0, g0)
        assert a == b, f
        assert _decisions(tm) == _decisions(jm), f
        took.append(b)
        reasons |= {d[2] for d in _decisions(tm)}
    _assert_same_graph(jm, tm)
    assert tm._kp_count0 == jm._kp_count0
    assert tm.n_nodes > 5 and tm.host.n_seq_edges > tm.n_nodes
    if case == "redundancy":
        assert not all(took[1:])  # frames were dropped
    assert {"ok", "ransac_failed"} <= reasons
    if case == "max_connections":
        assert "emm_rejected" in reasons
    if case == "motion_insane":
        assert "motion_insane" in reasons
    if case == "first_node_replacement":
        assert not took[1]
    if case == "keep_good_nodes":
        assert took[1] and tm.host.edge_types.count(3) >= 1  # constant-position edges
    assert tm.host.clear_queue == jm._clear_queue
    if case == "clear_non_keyframes":
        assert not tm.store.kp_valid[: tm.n_nodes].any(dim=1).all()  # some were cleared

    # localization only: frames are posed against the frozen map
    jm.toggle_mapping(False)
    tm.toggle_mapping(False)
    for f in range(N_MAP, N_FRAMES):
        clock["frame"] = f
        assert jm.add_frame(rgbs[f], depths[f], f / 30.0) == tm.add_frame(
            rgbs[f], depths[f], f / 30.0)
        assert _decisions(tm) == _decisions(jm)
        np.testing.assert_allclose(tm.localization_pose, jm.localization_pose, atol=1e-5)
    assert len(tm.localization_trajectory) == len(jm.localization_trajectory) > 0
    assert tm.n_nodes == jm.n_nodes
    jm.toggle_mapping(True)
    tm.toggle_mapping(True)

    jm.delete_last_frame()
    tm.delete_last_frame()
    _assert_same_graph(jm, tm)
