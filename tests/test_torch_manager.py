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
rescues and none otherwise. The device step's options (the projective
refinement, Hessian edges, the exact EMM, the delta wire, the raw wire and
5-bit luma): the default path still waits once a frame, and replayed groups
equal eager steps. With the appearance retrieval (global_loop_candidates):
replayed groups make no synchronizing call and equal the eager groups bit
for bit, the default path reads the card once more on a frame that
retrieves, and the chunked retrieval equals its plain version on the card;
the stereo disparity on the card equals the CPU's. MultiSequenceSlam's
lockstep frames replayed as one CUDA graph equal the same frames stepped
eagerly bit for bit, with no synchronizing call in a replayed frame.
Imports no JAX, so it runs on the card:

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
from rgbdslam_v2_tpu_torch.parallel.slam_multi import MultiSequenceSlam
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



@pytest.mark.cuda
def test_default_path_with_the_options_reads_the_card_once_a_frame():
    """default_params() with the projective refinement, Hessian edges and
    the exact EMM: still ONE device->host copy a frame (the comparison,
    the keypoint count and the (B, 6, 6) information packed together), and
    one refine launch a frame after the first (the projective stage runs
    inside it)."""
    poses, rgbs, depths = _render(20)
    pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(
        g2o_transformation_refinement=3, tpu_edge_info="hessian", tpu_emm_exact=True)))
    mgr = pipe.manager
    online = mgr.optimize

    def unwatched_optimize(*args, **kw):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return online(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    mgr.optimize = unwatched_optimize
    registration.reset_launches()
    per_frame = [_sync_sites(lambda: pipe.process_frame(
        rgbs[i], depths[i], i / 30.0, gt_pose=poses[0] if i == 0 else None))
        for i in range(len(rgbs))]
    for i, sites in enumerate(per_frame[1:], 1):
        assert sites.count("graph/manager.py") == 1, (i, sites)
        assert set(sites) <= {"graph/manager.py", "backend.py"}, (i, sites)
    assert registration.LAUNCHES == len(rgbs) - 1
    info = mgr.graph.edge_info[: mgr.n_edges].cpu().numpy()
    assert np.isfinite(info).all() and np.abs(info[:, 0, 1]).max() > 0  # anisotropic


OPTION_GROUPS = {
    "wire_delta": (2, dict(tpu_ingest_format="yc12", tpu_wire_delta=True,
                           tpu_wire_delta_max_clamp=0.3)),
    "g2o_refinement": (4, dict(g2o_transformation_refinement=3)),
    "hessian_emm_exact": (4, dict(tpu_edge_info="hessian", tpu_emm_exact=True)),
    "raw": (4, dict(tpu_ingest_format="raw")),
    "gray5": (4, dict(tpu_ingest_format="yc12", tpu_gray_bits=5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("option", sorted(OPTION_GROUPS))
def test_option_grouped_replay_equals_eager_steps(option):
    """test_grouped_replay_equals_eager_steps with each of the device
    step's options: n frames a step replayed against 1 eager; poses within
    1e-6, equal statistics, no synchronizing call in a replayed group, one
    refine launch a frame after the first. Under the delta wire (a clamp
    budget of 0.3 lets P wires through at 640x480) both runs ship the same
    I and P wires."""
    n, over = OPTION_GROUPS[option]
    poses, rgbs, depths = _render(25)
    stamps = np.arange(25) / 30.0
    runs = {}
    for k in (1, n):
        pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(
            {**BENCH, "tpu_candidate_batch": 4, "optimizer_skip_step": 100,
             "tpu_frames_per_step": k, **over}))
        group, mgr = pipe._process_group, pipe.manager
        replay_sites, lengths, encode = [], [], mgr.encode

        def watched(*a, _group=group, _mgr=mgr, **kw):
            sg = _mgr.step_graph
            before = (sg.captures, sg.eager_groups)
            sites = _sync_sites(lambda: _group(*a, **kw))
            if (sg.captures, sg.eager_groups) == before:
                replay_sites.append(sites)

        pipe._process_group = watched
        mgr.encode = lambda *a, _enc=encode, _out=lengths: _out.append(len(w := _enc(*a))) or w
        registration.reset_launches()
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        runs[k] = (mgr.poses(), mgr.statistics(), registration.LAUNCHES, replay_sites, lengths)
    (p1, s1, r1, _, l1), (pn, sn, rn, sites, ln) = runs[1], runs[n]
    assert sites and all(not s for s in sites), sites
    assert rn == r1 == 24
    assert sn == s1 and ln == l1
    np.testing.assert_allclose(pn, p1, rtol=0, atol=1e-6)
    if option == "wire_delta":
        assert len(set(l1)) == 2  # I and P wires both flowed


# global_loop_candidates=2 with room among make_pipe's 8 candidates for the
# retrieval's hits, no online optimize
RETRIEVAL_BENCH = dict(BENCH, global_loop_candidates=2, neighbor_candidates=1,
                       min_sampled_candidates=0, optimizer_skip_step=100)


@pytest.mark.cuda
def test_retrieval_replayed_groups_make_no_sync_and_equal_eager_groups():
    """make_pipe with the deferred retrieval, 4 frames a step on 40 frames
    of 640x480: no replayed group synchronizes (the retrieval is queued
    behind the step and its counts are read a step call later, waiting on
    their event); the run replayed as CUDA graphs equals the same groups
    stepped eagerly bit for bit, hits included."""
    poses, rgbs, depths = _render(40)
    runs = []
    for eager in (False, True):
        pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(dict(RETRIEVAL_BENCH)))
        mgr = pipe.manager
        sg, replay_sites = mgr.step_graph, []
        if eager:
            mgr.step_graph = None
        else:
            group = pipe._process_group

            def watched(*a, **kw):
                before = (sg.captures, sg.eager_groups)
                sites = _sync_sites(lambda: group(*a, **kw))
                if (sg.captures, sg.eager_groups) == before:
                    replay_sites.append(sites)

            pipe._process_group = watched
        pipe.run_arrays(rgbs, depths, np.arange(40) / 30.0, gt_poses=poses)
        runs.append((mgr.poses(), mgr.statistics(), mgr.retrievals, mgr.retrieval_hits,
                     sg.replays, replay_sites))
    (p_r, s_r, n_r, h_r, replays, sites), (p_e, s_e, n_e, h_e, _, _) = runs
    assert replays >= 1 and sites and all(not s for s in sites), sites
    assert n_r == n_e >= 1 and h_r == h_e >= 1
    assert s_r == s_e
    np.testing.assert_array_equal(p_r, p_e)


@pytest.mark.cuda
def test_default_path_retrieval_adds_one_read():
    """default_params() with global_loop_candidates=2 on 30 frames of
    640x480: a frame whose candidates leave room retrieves, and reads its
    hits in one more copy (graph/loop_closing.py); every frame reads its
    comparison once (graph/manager.py), the online optimize outside the
    count."""
    poses, rgbs, depths = _render(30)
    pipe = SlamPipeline(TUM_DEFAULT, ParameterServer({"global_loop_candidates": 2}))
    mgr = pipe.manager
    online = mgr.optimize

    def unwatched_optimize(*args, **kw):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return online(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    mgr.optimize = unwatched_optimize
    frames = []
    for i in range(len(rgbs)):
        before = mgr.retrievals
        sites = _sync_sites(lambda: pipe.process_frame(
            rgbs[i], depths[i], i / 30.0, gt_pose=poses[0] if i == 0 else None))
        frames.append((sites, mgr.retrievals - before))
    assert sum(k for _, k in frames) >= 1
    for i, (sites, k) in enumerate(frames[1:], 1):
        assert sites.count("graph/manager.py") == 1, (i, sites)
        assert sites.count("graph/loop_closing.py") == k, (i, sites, k)
        assert set(sites) <= {"graph/manager.py", "graph/loop_closing.py", "backend.py"}


@pytest.mark.cuda
@pytest.mark.parametrize("n_active", [1, 37, 64])
def test_retrieval_chunked_equals_plain_on_the_card(n_active):
    """The chunked active-rows route against the capacity-wide plain
    version on a 64-node store of +/-1 descriptors whose nodes are noisy
    copies (10-40% of the signs flipped) of the query node's, one of them
    a near copy (2%), in chunks of 1000 columns."""
    from rgbdslam_v2_tpu_torch.graph import loop_closing
    from rgbdslam_v2_tpu_torch.graph.node_store import NodeStore

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    N, K, D = 64, 600, 256
    q = n_active - 1
    base = torch.where(torch.rand((K, D), generator=gen, device="cuda") < 0.5, 1, -1)
    noise = torch.rand((N, 1, 1), generator=gen, device="cuda") * 0.3 + 0.1
    noise[q] = 0.0
    noise[max(q - 5, 0)] = 0.02 if q >= 5 else noise[0]
    flip = torch.rand((N, K, D), generator=gen, device="cuda") < noise
    desc = torch.where(flip, -base, base).to(torch.int8)
    one = torch.zeros((N, 1), device="cuda")
    store = NodeStore(uv=torch.zeros((N, K, 2), device="cuda"),
                      xyz=torch.zeros((N, K, 3), device="cuda"), desc=desc,
                      kp_valid=torch.rand((N, K), generator=gen, device="cuda") < 0.9,
                      depth=one, emm_lohi=one.int(), color=one.to(torch.uint8))
    got = loop_closing.global_match_scores_from_store(store, q, n_active, exclude_window=2,
                                                      chunk_columns=1000)
    plain = loop_closing.global_match_scores_plain(
        loop_closing.query_from_store(store, q), store,
        torch.arange(N, device="cuda") < n_active,
        loop_closing.exclude_window_mask(N, q, 2, "cuda"))
    assert torch.equal(got, plain)
    assert n_active < 8 or int(got.sum()) > 0


@pytest.mark.cuda
def test_stereo_disparity_on_the_card_equals_the_cpu():
    """ops/stereo.py at 640x480 on a rendered rectified pair: the card's
    disparity, validity and depth equal the CPU's bit for bit (every sum
    has one order of float32 additions)."""
    from rgbdslam_v2_tpu_torch.io.stereo_input import png_gray, render_stereo_sequence
    from rgbdslam_v2_tpu_torch.ops import stereo

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = SyntheticWorld.create(seed=1, cam=TUM_DEFAULT)
    _, lefts, rights, _ = render_stereo_sequence(world, 1, 0.075, seed=2, device="cuda")
    gl = torch.from_numpy(png_gray(lefts[0]).astype(np.float32) / 255.0)
    gr = torch.from_numpy(png_gray(rights[0]).astype(np.float32) / 255.0)
    host = stereo.stereo_depth(gl, gr, TUM_DEFAULT.fx, 0.075)
    card = stereo.stereo_depth(gl.cuda(), gr.cuda(), TUM_DEFAULT.fx, 0.075)
    assert float(host[1].float().mean()) > 0.3
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_multi_sequence_replay_equals_eager():
    """MultiSequenceSlam, 3 sequences of bench.py's configuration with 4
    candidates and no online optimize in the run (pose_relative_to forced
    to "first"), 14 lockstep frames of 640x480: the frames replayed as one
    CUDA graph of the 3 step bodies equal the same frames stepped eagerly
    bit for bit (poses, edge mirrors, keyframes). A replayed lockstep frame
    makes no synchronizing call; detect launches 3 times a frame and refine
    3 times a frame after the first, replays included. A new key (a
    sequence's adapted FAST threshold) runs eagerly once and is captured."""
    S, frames = 3, 14
    seqs = []
    for s in range(S):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        world = SyntheticWorld.create(seed=s, cam=TUM_DEFAULT)
        poses, rgbs, depths = render_sequence(world, frames, seed=10 + s, device="cuda")
        seqs.append((poses, rgbs, np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)))
    runs = {}
    for eager in (False, True):
        ms = MultiSequenceSlam(TUM_DEFAULT, S, params=ParameterServer(
            {**BENCH, "tpu_candidate_batch": 4, "optimizer_skip_step": 100,
             "tpu_frames_per_step": 1}))
        if eager:
            for sh in ms.shards:
                sh.steps = None
        wires = [[ms.compact(r, d) for r, d in zip(x[1], x[2])] for x in seqs]
        detect.reset_launches()
        registration.reset_launches()
        sites, steps = [], ms.shards[0].steps
        for k in range(frames):
            before = steps and (steps.captures, steps.eager_groups)
            frame_sites = _sync_sites(lambda: ms.add_frames(
                np.stack([w[k] for w in wires]), np.full(S, k / 30.0),
                gt_poses=np.stack([x[0][0] for x in seqs]) if k == 0 else None))
            if k > 0 and steps and (steps.captures, steps.eager_groups) == before:
                sites.append(frame_sites)  # a replayed lockstep frame
        launches = (detect.LAUNCHES, registration.LAUNCHES)
        ms._drain()
        runs[eager] = (ms.trajectories(), [(sq.host.edge_active.copy(), sq.host.edge_i.copy(),
                                            list(sq.host.keyframes)) for sq in ms.seq],
                       launches, sites, ms.shards[0].steps)
    (p_g, h_g, l_g, sites, steps), (p_e, h_e, l_e, _, _) = runs[False], runs[True]
    # a key (every sequence's FAST threshold) runs eagerly, then is captured
    # and replayed on its next frame; every frame after the first steps once
    assert steps.eager_groups == steps.captures >= 1
    assert steps.eager_groups + steps.replays == frames - 1
    assert len(sites) == steps.replays - steps.captures >= frames - 7
    assert all(not s for s in sites), sites
    assert l_g == l_e == (S * frames, S * (frames - 1))
    np.testing.assert_array_equal(p_g, p_e)
    for (a_g, i_g, k_g), (a_e, i_e, k_e) in zip(h_g, h_e):
        np.testing.assert_array_equal(a_g, a_e)
        np.testing.assert_array_equal(i_g, i_e)
        assert k_g == k_e
