"""Appearance-based loop retrieval in the port (graph/loop_closing.py, its
place in candidate selection) against the JAX package, at 160x120.

Stores carried across from the JAX package (ORB int8 and SIFT float32
descriptors of JAX-extracted frames): the port's counts equal
global_match_scores_from_store's exactly, on the chunked active-rows route
and on the capacity-wide plain version, and retrieve_loop_candidates
returns the same ids. End to end on tests/test_loop_closure.py's 130-frame
orbit (3 deg a frame, depth noise) with global_loop_candidates=2 and no
random keyframe sampling, the port finds loop edges spanning more than 50
frames, one frame a step, four a step, and on the host-decision path.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.core.frames import make_frame as jmake_frame  # noqa: E402
from rgbdslam_v2_tpu.graph import loop_closing as jlc  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import GraphManager as JManager  # noqa: E402
from rgbdslam_v2_tpu.graph.node_store import NodeStore as JStore  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import loop_closing  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_LOOP  # noqa: E402
from rgbdslam_v2_tpu_torch.io import SyntheticWorld  # noqa: E402
from rgbdslam_v2_tpu_torch.io.synthetic import render_sequence  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_STORE, N_FILLED = 16, 12  # store capacity, nodes written
FAMILIES = {"orb_int8": dict(max_keypoints=256),
            "sift_float32": dict(max_keypoints=128, feature_detector_type="SIFT")}


@pytest.fixture(scope="module")
def frames():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FILLED + 1, seed=2)
    return rgbs, depths


@pytest.fixture(scope="module", params=list(FAMILIES))
def stores(request, frames):
    """The JAX-extracted keypoints of 13 frames; the first 12 written as
    nodes 0..11 of a 16-node JAX store, and that store in the port."""
    mgr = JManager(JIntrinsics(*CAM), JParams(dict(FAMILIES[request.param])))
    kps = [mgr.extract(jmake_frame(jnp.asarray(rgb), jnp.asarray(depth), JIntrinsics(*CAM)))
           for rgb, depth in zip(*frames)]
    K, D = kps[0].desc.shape
    dtype = np.asarray(kps[0].desc).dtype
    arr = dict(uv=np.zeros((N_STORE, K, 2), np.float32), xyz=np.zeros((N_STORE, K, 3), np.float32),
               desc=np.zeros((N_STORE, K, D), dtype), kp_valid=np.zeros((N_STORE, K), bool),
               depth=np.zeros((N_STORE, 4), np.float32), emm_lohi=np.zeros((N_STORE, 4), np.uint32),
               emm_zs=np.zeros((N_STORE, 4), np.float32),
               color=np.zeros((N_STORE, 12), np.uint8))
    for i, kp in enumerate(kps[:N_FILLED]):
        for name, field in (("uv", "uv"), ("xyz", "xyz"), ("desc", "desc"), ("kp_valid", "valid")):
            arr[name][i] = np.asarray(getattr(kp, field))
    jstore = JStore(**{k: jnp.asarray(v) for k, v in arr.items()})
    return jstore, interop.store_from_numpy(arr), kps[N_FILLED]


@pytest.mark.parametrize("query_id,window", [(3, 2), (8, 2), (11, 8)])
def test_counts_equal_jax(stores, query_id, window):
    jstore, store, _ = stores
    want = np.asarray(jlc.global_match_scores_from_store(
        jstore, np.int32(query_id), np.int32(N_FILLED), exclude_window=window))
    assert want.sum() > 0
    for chunk in (0, 1, 37, 256):  # 1: a column a chunk; 0: CHUNK_BYTES
        got = loop_closing.global_match_scores_from_store(store, query_id, N_FILLED,
                                                          exclude_window=window,
                                                          chunk_columns=chunk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"chunk {chunk}")


@pytest.mark.parametrize("n_active", [1, 5, N_FILLED, N_STORE])
def test_chunked_route_equals_plain(stores, n_active):
    """The active-rows route against the capacity-wide plain version, with
    inactive rows beyond n_active (their descriptors are real: they still
    read 1e9 in the plain version) and query rows a block at a time."""
    _, store, q = stores
    query = interop.keypoints_from_numpy({k: np.asarray(v) for k, v in q._asdict().items()})
    excl = loop_closing.exclude_window_mask(N_STORE, 6, 1, "cpu")
    active = torch.arange(N_STORE) < n_active
    plain = loop_closing.global_match_scores_plain(query, store, active, excl)
    blocked = loop_closing.global_match_scores_plain(query, store, active, excl, query_rows=7)
    for chunk in (0, 1, 100):
        got = loop_closing.global_match_scores(query, store, n_active, excl, chunk_columns=chunk)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(blocked.numpy(), plain.numpy())


def test_retrieve_loop_candidates_ids_equal(stores):
    jstore, store, q = stores
    query = interop.keypoints_from_numpy({k: np.asarray(v) for k, v in q._asdict().items()})
    for excl, min_votes in (([N_FILLED], 1), ([N_FILLED, 11, 10], 2), ([0, N_FILLED], 10)):
        want = jlc.retrieve_loop_candidates(q, jstore, N_FILLED, excl, top_n=3,
                                            min_votes=min_votes)
        got = loop_closing.retrieve_loop_candidates(query, store, N_FILLED, excl, top_n=3,
                                                    min_votes=min_votes)
        assert got == want


def _jax_pipelined_branch(counts, out, new_id, n_global, B, min_hits):
    """The JAX select_candidates' pipelined branch
    (rgbdslam_v2_tpu/graph/manager.py:1282-1295), on a copy of out."""
    out, n_added = list(out), 0
    for i in np.argsort(-counts):
        i = int(i)
        if counts[i] >= min_hits and i not in out and i != new_id:
            out.append(i)
            n_added += 1
        if n_added >= n_global or len(out) >= B:
            break
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ranked_hits_as_jax_selection(seed):
    """The keep-all selection's use of the counts: numpy's argsort of
    -counts (equal counts in its order), min_hits, not in out nor the new
    id, the budgets n_global and B, as the JAX branch appends them."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        counts = rng.integers(0, 20, 24).astype(np.int32)
        out = [int(x) for x in rng.choice(24, rng.integers(0, 6), replace=False)]
        new_id, n_global, B, min_hits = 23, int(rng.integers(1, 4)), 8, int(rng.integers(0, 15))
        got = out + loop_closing.ranked_hits(counts, out, new_id, n_global, B, min_hits)
        assert got == _jax_pipelined_branch(counts, out, new_id, n_global, B, min_hits)


# tests/test_loop_closure.py's orbit and parameters, the port's renderer
N_ORBIT = 130
ORBIT = dict(max_keypoints=256, tpu_max_nodes=192, tpu_max_edges=2048, tpu_candidate_batch=6,
             ransac_iterations=128, min_matches=12, predecessor_candidates=2,
             neighbor_candidates=1, min_sampled_candidates=0, optimizer_skip_step=1000,
             keep_all_nodes=True, observability_threshold=0.5, global_loop_candidates=2)


@pytest.fixture(scope="module")
def orbit():
    world = SyntheticWorld.create(seed=0, texture_size=256, cam=Intrinsics(*CAM))
    traj = world.orbit_trajectory(N_ORBIT, seed=2, deg_per_frame=3.0, device="cpu").numpy()
    poses, rgbs, depths = render_sequence(world, N_ORBIT, trajectory=traj, device="cpu")
    rng = np.random.default_rng(7)  # Kinect-style noise + TUM quantization
    d = np.where(depths > 0, depths + rng.normal(size=depths.shape) * 0.01 * depths ** 2, 0.0)
    return poses, rgbs, (np.round(d * 5000.0) / 5000.0).astype(np.float32), \
        np.arange(N_ORBIT) / 30.0


@pytest.mark.parametrize("over", [
    {}, {"tpu_frames_per_step": 4}, {"keep_all_nodes": False},
], ids=["one_a_step", "four_a_step", "host_path"])
def test_orbit_retrieval_closes_loops(orbit, over):
    poses, rgbs, depths, stamps = orbit
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer({**ORBIT, **over}), device="cpu")
    pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    mgr = pipe.manager
    stats = mgr.statistics()
    spans = [abs(i - j) for t, pair in zip(mgr.host.edge_types, mgr.host.edge_pairs)
             if t == EDGE_LOOP and pair is not None for (i, j) in [pair]]
    assert mgr.retrievals > 0
    assert stats["loop_edges"] > 0, stats
    assert max(spans) > 50, spans
