"""The keep-all fast path's dispatch options in the port, on the CPU: the
starvation alert against the JAX package's, and the grouped, pipelined and
encode-ahead paths against the ungrouped, blocking and synchronous ones
(the JAX package holds its own the same way in tests/test_round2_features.py
and tests/test_dct_wire.py). End to end, bench.py's make_pipe parameters at
160x120 land in the JAX package's ATE band with accepted edges within 25%
(RANSAC draws differ, ROADMAP F1)."""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import GraphManager as JManager  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.ops import dct_wire as jdw  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 24
# bench.py's make_pipe parameters, capacities cut to the sequence
MAKE_PIPE = dict(
    max_keypoints=600, tpu_max_nodes=64, tpu_max_edges=512, tpu_candidate_batch=8,
    ransac_iterations=200, optimizer_skip_step=10, keep_all_nodes=True,
    observability_threshold=0.5, pose_relative_to="inaffected", emm_skip_step=4,
    tpu_ingest_format="ydct", tpu_dct_quality="2.7", tpu_gray_bits=8, tpu_depth_bits=10,
    tpu_frames_per_step=4, tpu_encode_ahead=True,
)
# the equality runs: 4 candidates (the predecessors, so selection does not
# depend on when drains land) and no online optimize, as the JAX tests
SMALL = dict(MAKE_PIPE, max_keypoints=256, tpu_candidate_batch=4, ransac_iterations=128,
             min_matches=12, optimizer_skip_step=100)


@pytest.fixture(scope="module")
def sequence():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=2)
    return np.asarray(poses), rgbs, depths, np.arange(N_FRAMES) / 30.0


@pytest.fixture
def jax_quality():
    found = jdw.QUALITY
    yield
    jdw.set_quality(found)


def _run(params, seq, frames=N_FRAMES):
    poses, rgbs, depths, stamps = seq
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    pipe.run_arrays(rgbs[:frames], depths[:frames], stamps[:frames], gt_poses=poses)
    return pipe


def _graph(pipe):
    m = pipe.manager
    m._drain_pending()
    assert not m._staged and not m._pending
    h = m.host
    return (m.n_nodes, m.n_edges, h.edge_i[: m.n_edges].tolist(),
            h.edge_j[: m.n_edges].tolist(), h.edge_active[: m.n_edges].tolist(),
            list(h.edge_types), list(h.keyframes), m.statistics())


@pytest.mark.parametrize("fmt", ["yc12", "ydct"])
def test_starvation_alert_matches_jax(fmt, sequence, jax_quality):
    """A lights-off stretch (frames 8-15 at a tenth of the brightness) and
    the recovery: the same alerts, starved mode and contrast average."""
    _, rgbs, depths, _ = sequence
    over = dict(tpu_ingest_format=fmt, tpu_max_nodes=8, tpu_max_edges=64,
                tpu_candidate_batch=2, max_keypoints=64)
    jm = JManager(JIntrinsics(*CAM), JParams(dict(MAKE_PIPE, **over)))
    tm = GraphManager(Intrinsics(*CAM), ParameterServer(dict(MAKE_PIPE, **over)), device="cpu")
    trace_j, trace_t = [], []
    for i in range(N_FRAMES):
        rgb = rgbs[i] if not 8 <= i < 16 else (rgbs[i] // 10).astype(np.uint8)
        wire = tm.encode(rgb, depths[i])
        trace_t.append((tm._starvation_alert(wire), tm._starved_mode, tm._contrast_ema))
        trace_j.append((jm._starvation_alert(wire), jm._starved_mode, jm._contrast_ema))
    assert [a for a, _, _ in trace_t].count(True) == 2, trace_t
    assert trace_t == trace_j


def test_pipelined_drains_give_the_blocking_graph(sequence, monkeypatch):
    """tpu_drain_pipelined with every other look at a staged copy reporting
    it in flight (so batches really wait) against blocking drains, drain
    interval 3, an online optimize every frame."""
    over = dict(SMALL, tpu_frames_per_step=1, tpu_encode_ahead=False, tpu_drain_interval=3,
                optimizer_skip_step=0, pose_relative_to="first")
    looks = []

    def landed(event):
        # staged batches carry no event on the CPU: report every other look
        # as still in flight
        looks.append(event)
        return len(looks) % 2 == 0

    blocking = _run(dict(over, tpu_drain_pipelined=False), sequence, 14)
    monkeypatch.setattr(GraphManager, "_landed", staticmethod(landed))
    pipelined = _run(dict(over, tpu_drain_pipelined=True), sequence, 14)
    assert len(looks) > 2
    assert _graph(pipelined) == _graph(blocking)
    np.testing.assert_allclose(pipelined.manager.poses(), blocking.manager.poses(), atol=1e-5)


def test_pipelined_drains_read_one_step_call_late(sequence, monkeypatch):
    """The shipped landing rule with copies that report in flight (as on
    the card): each staged batch is read, waiting on its event, exactly one
    step call after the drain that staged it, whatever the copy reports;
    the graph equals the blocking drains' and every such wait is counted."""
    over = dict(SMALL, tpu_frames_per_step=1, tpu_encode_ahead=False, tpu_drain_interval=3,
                pose_relative_to="first")
    reads = []  # (step call the copy was started in, step call it was read in)

    class InFlight:
        def __init__(self, mgr):
            self.mgr, self.started = mgr, mgr._step_calls

        def query(self):
            return False

        def synchronize(self):
            reads.append((self.started, self.mgr._step_calls))

    monkeypatch.setattr(GraphManager, "_start_copy",
                        lambda self, summary: (summary, InFlight(self)))
    pipelined = _run(dict(over, tpu_drain_pipelined=True), sequence, 14)
    waits = pipelined.manager.copy_waits
    monkeypatch.undo()
    blocking = _run(dict(over, tpu_drain_pipelined=False), sequence, 14)
    assert len(reads) >= 3 and all(read == started + 1 for started, read in reads), reads
    assert waits == len(reads)
    assert _graph(pipelined) == _graph(blocking)
    np.testing.assert_allclose(pipelined.manager.poses(), blocking.manager.poses(), atol=1e-5)


def test_four_frames_a_step_equal_one(sequence):
    one = _run(dict(SMALL, tpu_frames_per_step=1, tpu_encode_ahead=False), sequence)
    four = _run(dict(SMALL, tpu_frames_per_step=4, tpu_encode_ahead=False), sequence)
    assert four.manager.n_nodes == one.manager.n_nodes == N_FRAMES
    np.testing.assert_allclose(four.manager.poses(), one.manager.poses(), rtol=0, atol=1e-6)
    assert _graph(four) == _graph(one)


def test_encode_ahead_sends_the_same_wires(sequence, monkeypatch):
    wires = {}
    for ahead in (False, True):
        seen = []
        add_group, add_frame = GraphManager.add_frame_group, GraphManager.add_frame

        def group(self, compacts, tss, _f=add_group, _seen=seen):
            _seen.extend(np.array(c) for c in compacts)
            return _f(self, compacts, tss)

        def frame(self, rgb, depth, ts, gt=None, compact=None, _f=add_frame, _seen=seen):
            _seen.append(np.array(compact))
            return _f(self, rgb, depth, ts, gt, compact=compact)

        monkeypatch.setattr(GraphManager, "add_frame_group", group)
        monkeypatch.setattr(GraphManager, "add_frame", frame)
        pipe = _run(dict(SMALL, tpu_encode_ahead=ahead), sequence, 13)
        monkeypatch.undo()
        wires[ahead] = (seen, pipe.manager.poses(), _graph(pipe))
    assert len(wires[True][0]) == len(wires[False][0]) == 13
    for a, b in zip(wires[True][0], wires[False][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(wires[True][1], wires[False][1])
    assert wires[True][2] == wires[False][2]


def test_make_pipe_parameters_land_in_the_jax_band(sequence, tmp_path, jax_quality):
    poses, rgbs, depths, stamps = sequence
    reports = {}
    for name, pipe in (
            ("jax", JPipeline(JIntrinsics(*CAM), JParams(dict(MAKE_PIPE)))),
            ("torch", SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(MAKE_PIPE)),
                                   device="cpu"))):
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        rep = pipe.evaluation_protocol(tmp_path / name, gt_stamps=list(stamps),
                                       gt_xyz=poses[:, :3, 3])
        stats = pipe.manager.statistics()
        reports[name] = (rep.ate_rmse, stats["sequential_edges"] + stats["loop_edges"],
                         pipe.manager.n_nodes)
    (j_ate, j_acc, j_n), (t_ate, t_acc, t_n) = reports["jax"], reports["torch"]
    assert j_n == t_n == N_FRAMES
    assert j_ate[4] < 0.03 and t_ate[4] < 0.03, reports
    assert abs(t_acc - j_acc) <= 0.25 * j_acc, reports
