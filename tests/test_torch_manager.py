"""GraphManager behaviour of the port that needs no JAX oracle: which
optimize calls report their iteration count (the JAX package's rule, set at
rgbdslam_v2_tpu/graph/manager.py in GraphManager.optimize), and, on the
card (marker `cuda`): the default configuration's host-decision path waits
for the card once a frame, the keep-all step never, and a group of frames
replayed as one CUDA graph equals the same frames stepped one by one (also
for the SIFTGPU, BRISK and FREAK families, and int8, bf16 and float32
descriptor stores give equal poses). With
the GICP rescue (use_icp) on a 640x480 dark stretch: the keep-all path
waits for the card only at the blocking drains of its starved mode (never
for a rescue in flight), replayed groups with rescues equal the same groups
stepped eagerly, and the default path adds one wait on a frame that
rescues and none otherwise. Imports no JAX, so it runs on the card:

    python -m pytest --noconftest tests/test_torch_manager.py -q
"""
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbdslam_v2_tpu_torch.config import ParameterServer, default_params
from rgbdslam_v2_tpu_torch.core import alignment
from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT, Intrinsics
from rgbdslam_v2_tpu_torch.graph.device_step import group_views, slam_stepN
from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence
from rgbdslam_v2_tpu_torch.io.synthetic import dark_stretch
from rgbdslam_v2_tpu_torch.ops import detect, registration
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

torch.set_num_threads(1)
CAM = Intrinsics(130.0, 130.0, 80.0, 60.0, 160, 120)
PARAMS = dict(
    max_keypoints=256, tpu_max_nodes=16, tpu_max_edges=128, tpu_candidate_batch=4,
    ransac_iterations=64, min_matches=12, optimizer_skip_step=100, keep_all_nodes=True,
    observability_threshold=0.5, tpu_drain_pipelined=False,
)
# bench.py's make_pipe configuration (keep-all, ydct 2.7, 4 frames a step,
# encode-ahead, pipelined drains, inaffected optimize every 10 frames)
BENCH = dict(
    max_keypoints=600, tpu_max_nodes=1024, tpu_max_edges=8192, tpu_candidate_batch=8,
    ransac_iterations=200, optimizer_skip_step=10, keep_all_nodes=True,
    observability_threshold=0.5, pose_relative_to="inaffected", emm_skip_step=4,
    tpu_ingest_format="ydct", tpu_dct_quality="2.7", tpu_gray_bits=8, tpu_depth_bits=10,
    tpu_frames_per_step=4, tpu_encode_ahead=True,
)


@pytest.fixture(scope="module")
def manager():
    world = SyntheticWorld.create(seed=0, texture_size=128, cam=CAM)
    _, rgbs, depths = render_sequence(world, 4, seed=2, device="cpu")
    pipe = SlamPipeline(CAM, ParameterServer(dict(PARAMS)), device="cpu")
    pipe.run_arrays(rgbs, depths, np.arange(4) / 30.0)
    assert pipe.manager.n_nodes == 4
    return pipe.manager


def test_only_a_blocking_optimize_reports_its_iterations(manager):
    manager.last_optimize_iters = -1
    assert np.isnan(manager.optimize(blocking=False))
    assert manager.last_optimize_iters == -1  # the online call leaves it
    chi2 = manager.optimize(blocking=True)
    assert np.isfinite(chi2)
    assert 1 <= manager.last_optimize_iters <= manager.params["optimizer_iterations"]


def _sync_sites(fn):
    """Run fn with CUDA sync debugging on; the files whose lines made each
    synchronizing call, in order: relative to the package for the port's,
    "outside" for others."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    pkg = Path(__file__).resolve().parents[1] / "rgbdslam_v2_tpu_torch"
    out = []
    for w in rec:
        if "synchroniz" in str(w.message):
            f = Path(w.filename).resolve()
            out.append(f.relative_to(pkg).as_posix() if f.is_relative_to(pkg) else "outside")
    return out


def _render(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = SyntheticWorld.create(seed=0, cam=TUM_DEFAULT)
    poses, rgbs, depths = render_sequence(world, frames, seed=2, depth_noise_sigma=0.01,
                                          device="cuda")
    return poses, rgbs, np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)


def _render_dark(frames):
    """tools/hard_sequences.py's dark-stretch world at 640x480 (world seed
    7, render seed 8, depth noise), its middle fifth at ~3% contrast."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = SyntheticWorld.create(seed=7, cam=TUM_DEFAULT)
    poses, rgbs, depths = render_sequence(world, frames, seed=8, depth_noise_sigma=0.01,
                                          device="cuda")
    rgbs, lo, hi = dark_stretch(rgbs)
    assert hi - lo >= 4
    return poses, rgbs, np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)


@pytest.mark.cuda
def test_default_path_reads_the_card_once_a_frame():
    """default_params() with no device argument on the card, 30 frames of
    640x480: each add_frame's decisions come from ONE device->host copy,
    made in graph/manager.py (the comparison result and the keypoint count
    packed together). The online optimize, which reads its convergence
    flag on this path, runs outside the count. The only other
    synchronizing calls allowed are backend.constant's one-time copy of a
    new constant and, on the first frame, torch's own one-time CUDA setup
    (no Kabsch refit waits for the card: ROADMAP F6)."""
    poses, rgbs, depths = _render(30)
    pipe = SlamPipeline(TUM_DEFAULT, default_params())
    mgr = pipe.manager
    assert mgr.device.type == "cuda"
    online = mgr.optimize

    def unwatched_optimize(*args, **kw):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return online(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    mgr.optimize = unwatched_optimize
    per_frame = [_sync_sites(lambda: pipe.process_frame(
        rgbs[i], depths[i], i / 30.0, gt_pose=poses[0] if i == 0 else None))
        for i in range(len(rgbs))]
    allowed = {"graph/manager.py", "backend.py"}
    for i, sites in enumerate(per_frame):
        assert sites.count("graph/manager.py") == 1, (i, sites)
        assert set(sites) <= (allowed | {"outside"} if i == 0 else allowed), (i, sites)
    assert mgr.n_nodes + pipe.n_dropped == len(rgbs) and mgr.n_nodes > 20
    assert mgr.solver_calls["pcg"] == mgr.n_nodes - 1 and mgr.solver_calls["dense"] == 0
    # the rest of the manager on the card: delete the newest node, then
    # localize its frame against the frozen map
    del mgr.optimize
    n = mgr.n_nodes
    mgr.delete_last_frame()
    assert mgr.n_nodes == n - 1 and not bool(mgr.store.kp_valid[n - 1].any())
    assert not bool(mgr.graph.node_active[n - 1])
    mgr.toggle_mapping(False)
    assert pipe.process_frame(rgbs[-1], depths[-1], len(rgbs) / 30.0)
    assert mgr.n_nodes == n - 1 and np.isfinite(mgr.localization_pose).all()


@pytest.mark.cuda
def test_keep_all_step_reads_the_card_never():
    """bench.py's configuration one frame a step, 40 frames of 640x480:
    after the first two frames (torch's and the port's one-time setup) no
    frame makes a synchronizing call, the pipelined drains and the online
    inaffected optimizes included. Every frame after the first launches the
    RANSAC refine kernel once (the Kabsch kernel never) and every frame the
    detect kernel once."""
    poses, rgbs, depths = _render(40)
    pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(
        {**BENCH, "tpu_frames_per_step": 1, "tpu_encode_ahead": False}))
    detect.reset_launches()
    alignment.reset_launches()
    registration.reset_launches()
    per_frame = [_sync_sites(lambda: pipe.process_frame(
        rgbs[i], depths[i], i / 30.0, gt_pose=poses[0] if i == 0 else None))
        for i in range(len(rgbs))]
    assert all(not sites for sites in per_frame[2:]), per_frame
    assert detect.LAUNCHES == len(rgbs)
    assert registration.LAUNCHES == len(rgbs) - 1 and alignment.LAUNCHES == 0
    assert pipe.manager.statistics()["nodes"] == len(rgbs)


@pytest.mark.cuda
def test_grouped_replay_equals_eager_steps():
    """bench.py's configuration with 4 candidates (all predecessors, so the
    candidates do not depend on when drains land) and no online optimize in
    the run, as tests/test_round2_features.py holds the JAX package: 4
    frames a step, replayed as CUDA graphs, against 1 frame a step, eager.
    Trajectories agree within 1e-6 and the graphs' edges are equal; the
    replays draw the RANSAC samples the eager steps draw. A replayed group
    makes no synchronizing call and counts its kernels' launches."""
    poses, rgbs, depths = _render(25)
    stamps = np.arange(25) / 30.0
    runs = {}
    for n in (1, 4):
        pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(
            {**BENCH, "tpu_candidate_batch": 4, "optimizer_skip_step": 100,
             "tpu_frames_per_step": n}))
        group = pipe._process_group
        replay_sites = []

        def watched(*a, _group=group, _mgr=pipe.manager, **kw):
            sg = _mgr.step_graph
            before = (sg.captures, sg.eager_groups)
            sites = _sync_sites(lambda: _group(*a, **kw))
            if (sg.captures, sg.eager_groups) == before:
                replay_sites.append(sites)

        pipe._process_group = watched
        detect.reset_launches()
        alignment.reset_launches()
        registration.reset_launches()
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        runs[n] = (pipe.manager.poses(), pipe.manager.statistics(), detect.LAUNCHES,
                   (registration.LAUNCHES, alignment.LAUNCHES), pipe.manager.step_graph,
                   replay_sites)
    (p1, s1, d1, k1, _, _), (p4, s4, d4, k4, sg, sites) = runs[1], runs[4]
    assert (sg.captures, sg.eager_groups, sg.replays) == (1, 1, 5)
    assert len(sites) == 4 and all(not s for s in sites), sites
    assert d4 == d1 == 25 and k4 == k1 == (24, 0)  # (refine, Kabsch) launches
    assert s4 == s1
    np.testing.assert_allclose(p4, p1, rtol=0, atol=1e-6)


FAMILIES = {"SIFTGPU": dict(feature_detector_type="SIFTGPU", feature_extractor_type="SIFTGPU",
                            nn_distance_ratio=0.9),
            "BRISK": dict(feature_extractor_type="BRISK"),
            "FREAK": dict(feature_extractor_type="FREAK")}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_grouped_replay_equals_eager_steps(family):
    """The feature families through bench.py's configuration (4
    candidates, no online optimize in the run): 4 frames a step replayed as
    CUDA graphs against 1 frame a step, eager, give equal poses (exactly:
    the SIFT histograms are fixed-order sums, no atomic adds) and equal
    statistics; a replayed group makes no synchronizing call. Launches:
    the detect kernel once a frame for BRISK and FREAK (ORB's detector),
    never for SIFT; the refine kernel once a frame after the first."""
    poses, rgbs, depths = _render(25)
    stamps = np.arange(25) / 30.0
    runs = {}
    for n in (1, 4):
        pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(
            {**BENCH, **FAMILIES[family], "tpu_candidate_batch": 4,
             "optimizer_skip_step": 100, "tpu_frames_per_step": n}))
        group = pipe._process_group
        replay_sites = []

        def watched(*a, _group=group, _mgr=pipe.manager, **kw):
            sg = _mgr.step_graph
            before = (sg.captures, sg.eager_groups)
            sites = _sync_sites(lambda: _group(*a, **kw))
            if (sg.captures, sg.eager_groups) == before:
                replay_sites.append(sites)

        pipe._process_group = watched
        detect.reset_launches()
        registration.reset_launches()
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        runs[n] = (pipe.manager.poses(), pipe.manager.statistics(), detect.LAUNCHES,
                   registration.LAUNCHES, replay_sites)
    (p1, s1, d1, r1, _), (p4, s4, d4, r4, sites) = runs[1], runs[4]
    assert len(sites) == 4 and all(not s for s in sites), sites
    assert d4 == d1 == (0 if family == "SIFTGPU" else 25) and r4 == r1 == 24
    assert s4 == s1 and s1["sequential_edges"] > 25
    np.testing.assert_array_equal(p4, p1)


@pytest.mark.cuda
def test_descriptor_stores_give_equal_poses_on_the_card():
    """int8, bf16 and float32 stores, one frame a step, 25 frames of
    640x480, no online optimize in the run (its float atomic adds are not
    run-to-run exact): equal poses and statistics (the float stores' distances are 4
    x Hamming, computed in float32 whatever cuBLAS allows for bf16)."""
    poses, rgbs, depths = _render(25)
    stamps = np.arange(25) / 30.0
    runs = {}
    for dtype in ("int8", "bf16", "float32"):
        pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(
            {**BENCH, "tpu_frames_per_step": 1, "tpu_encode_ahead": False,
             "optimizer_skip_step": 100, "tpu_descriptor_dtype": dtype}))
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        runs[dtype] = (pipe.manager.poses(), pipe.manager.statistics())
    for dtype in ("bf16", "float32"):
        np.testing.assert_array_equal(runs[dtype][0], runs["int8"][0])
        assert runs[dtype][1] == runs["int8"][1]


ICP_BENCH = {**BENCH, "use_icp": True, "icp_max_iterations": 12, "tpu_candidate_batch": 4,
             "optimizer_skip_step": 100}


@pytest.mark.cuda
def test_rescues_in_flight_make_no_sync():
    """make_pipe with use_icp and a fixed FAST threshold, 4 frames a step,
    on 48 frames with a dark stretch: in every replayed group the
    synchronizing calls are exactly
    the blocking drain copies of starved mode (graph/manager.py, counted
    by blocking_pulls), so a group without one makes none, and such groups
    run with retroactive rescues in flight; no wait for a copy there leaves
    the card with no step queued (idle_waits); the rescue fires."""
    poses, rgbs, depths = _render_dark(48)
    # the detector threshold held (no adaptive ladder): every group after
    # the first two of the run replays the one captured graph
    pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(
        {**ICP_BENCH, "adjuster_max_iterations": 0}))
    mgr = pipe.manager
    group = pipe._process_group
    groups = []  # (sync sites, blocking pulls, rescues pending at the start, idle waits)

    def watched(*a, **kw):
        sg = mgr.step_graph
        before = (sg.captures, sg.eager_groups, mgr.blocking_pulls, len(mgr._pending_rescues),
                  mgr.idle_waits)
        sites = _sync_sites(lambda: group(*a, **kw))
        if (sg.captures, sg.eager_groups) == before[:2]:
            groups.append((sites, mgr.blocking_pulls - before[2], before[3],
                           mgr.idle_waits - before[4]))

    pipe._process_group = watched
    pipe.run_arrays(rgbs, depths, np.arange(48) / 30.0, gt_poses=poses)
    assert groups
    for sites, pulls, _, _ in groups:
        assert len(sites) == pulls and set(sites) <= {"graph/manager.py"}, (sites, pulls)
    assert any(pending and not pulls for _, pulls, pending, _ in groups), groups
    assert not any(idle for _, pulls, pending, idle in groups if pending and not pulls), groups
    assert mgr.rescue_items >= 1 and mgr.statistics()["icp_rescues"] >= 1


@pytest.mark.cuda
def test_replayed_groups_with_rescues_equal_eager_groups():
    """The same run, 4 frames a step with pipelined drains, once replayed as
    CUDA graphs and once with every group stepped eagerly frame by frame
    (slam_stepN): a staged drain is read one step call after it, however
    fast the host runs, so drains and rescues land at the same frames, the
    trajectories agree within 1e-6 and the statistics are equal; the rescue
    fired."""
    poses, rgbs, depths = _render_dark(48)
    runs = []
    for eager in (False, True):
        pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(ICP_BENCH)))
        mgr = pipe.manager
        if eager:
            def run(host_flat, n, L, B, cfg, _mgr=mgr):
                flat = host_flat.to(_mgr.device, non_blocking=True)
                return slam_stepN(_mgr.store, _mgr.graph, group_views(flat, n, L, B),
                                  _mgr.generator, **cfg)
            mgr.step_graph.run = run
        pipe.run_arrays(rgbs, depths, np.arange(48) / 30.0, gt_poses=poses)
        runs.append((mgr.poses(), mgr.statistics(), mgr.step_graph.replays))
    (p_replay, s_replay, replays), (p_eager, s_eager, _) = runs
    assert replays >= 1 and s_replay["icp_rescues"] >= 1
    assert s_replay == s_eager
    np.testing.assert_allclose(p_replay, p_eager, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_default_path_rescue_adds_one_pull():
    """default_params() with use_icp on 36 frames with a dark stretch: a
    frame that runs the batched rescue of its failed candidates waits for
    the card twice in graph/manager.py (the comparison, the rescue), every
    other frame once; the rescue fires."""
    poses, rgbs, depths = _render_dark(36)
    pipe = SlamPipeline(TUM_DEFAULT, ParameterServer({"use_icp": True}))  # the defaults + ICP
    mgr = pipe.manager
    online, rescue_batch = mgr.optimize, mgr._icp_rescue_batch
    calls = []

    def unwatched_optimize(*args, **kw):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return online(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def counted_rescue(*args, **kw):
        calls[-1] += 1
        return rescue_batch(*args, **kw)

    mgr.optimize, mgr._icp_rescue_batch = unwatched_optimize, counted_rescue
    for i in range(len(rgbs)):
        calls.append(0)
        sites = _sync_sites(lambda: pipe.process_frame(
            rgbs[i], depths[i], i / 30.0, gt_pose=poses[0] if i == 0 else None))
        if i > 0:
            assert sites.count("graph/manager.py") == 1 + calls[-1], (i, sites, calls[-1])
    assert sum(calls) >= 1 and mgr.statistics()["icp_rescues"] >= 1

