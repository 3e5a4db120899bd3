"""The host-decision path's spans and the online optimize's counters: one
of each decide.* span a compared frame, nested under its frame's span, and
none on the keep-all path; one optimize.lm span an LM iteration that
optimize ran; the manager's online_optimizes and online_lm_iterations
equal to the spans they count. Imports no JAX, so it runs on the card too:

    python -m pytest --noconftest tests/test_torch_decide_spans.py -q
"""
import numpy as np
import pytest
import torch

from rgbdslam_v2_tpu_torch.config import ParameterServer
from rgbdslam_v2_tpu_torch.core import se3
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence
from rgbdslam_v2_tpu_torch.optim.pose_graph import make_graph_state, optimize
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline
from rgbdslam_v2_tpu_torch.utils import timing

torch.set_num_threads(1)
CAM = Intrinsics(130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 14
# the default configuration's path (an online PCG optimize at every node),
# small
DEFAULT = dict(max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=512, tpu_candidate_batch=4,
               ransac_iterations=64, min_matches=12, backend_solver="pcg")
KEEP_ALL = dict(DEFAULT, keep_all_nodes=True, optimizer_skip_step=4,
                pose_relative_to="inaffected", tpu_frames_per_step=4)
STAGES = ("decide.extract", "decide.select", "decide.compare", "decide.pull", "decide.host")


@pytest.fixture(scope="module")
def sequence():
    world = SyntheticWorld.create(seed=0, texture_size=128, cam=CAM)
    poses, rgbs, depths = render_sequence(world, N_FRAMES, seed=2, device="cpu")
    return np.asarray(poses), rgbs, depths, np.arange(N_FRAMES) / 30.0


@pytest.fixture(autouse=True)
def fresh():
    timing.reset_timing_stats()
    yield
    timing.reset_timing_stats()


def _run(sequence, params, drop=()):
    poses, rgbs, depths, stamps = sequence
    pipe = SlamPipeline(CAM, ParameterServer(dict(params)), device="cpu")
    if drop:  # frames the program drops: their comparisons fail
        mgr, compare = pipe.manager, pipe.manager._compare_dispatch

        def failing(kp, depth_small, cand_idx):
            res = compare(kp, depth_small, cand_idx)
            if mgr.n_nodes + pipe.n_dropped in drop:
                res = res._replace(ransac_ok=torch.zeros_like(res.ransac_ok))
            return res

        mgr._compare_dispatch = failing
    pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    pipe.manager.statistics()  # drain
    return pipe, timing.span_stats()


@pytest.mark.parametrize("params", [DEFAULT, KEEP_ALL], ids=["host_decisions", "keep_all"])
def test_decide_spans_nest_under_frames(sequence, params):
    pipe, st = _run(sequence, params, drop=(5, 9) if params is DEFAULT else ())
    if params is KEEP_ALL:
        assert not [k for k in st if k.startswith("decide.")]
        return
    compared = N_FRAMES - 1  # every frame after the first
    assert pipe.n_dropped == 2 and pipe.manager.n_nodes == N_FRAMES - 2
    for name in STAGES:
        assert st[name]["count"] == compared, name
        assert set(st[name]["parents"]) == {"frames"}, name
    # a dropped frame commits nothing
    assert st["decide.commit"]["count"] == pipe.manager.n_nodes - 1
    assert set(st["decide.commit"]["parents"]) == {"frames"}
    children = sum(st[k]["parents"]["frames"]["total_s"] for k in st
                   if "frames" in st[k]["parents"])
    assert st["frames"]["total_s"] >= children


@pytest.mark.parametrize("read_convergence", [True, False])
def test_optimize_lm_spans_count_the_iterations(read_convergence):
    rng = np.random.default_rng(4)
    n, cap = 12, 64
    g = make_graph_state(cap, 64, device="cpu")
    xi = torch.tensor(np.cumsum(rng.normal(0, 0.2, (n, 6)), 0), dtype=torch.float32)
    gt = se3.exp_se3(xi)
    I = np.array([k - d for k in range(1, n) for d in (1, 2) if k >= d])
    J = np.array([k for k in range(1, n) for d in (1, 2) if k >= d])
    E = len(I)
    noise = se3.exp_se3(torch.tensor(rng.normal(0, 0.01, (E, 6)), dtype=torch.float32))
    g.poses[:n] = gt @ se3.exp_se3(torch.tensor(rng.normal(0, 0.05, (n, 6)),
                                                dtype=torch.float32))
    g.poses[0] = gt[0]
    g.node_active[:n] = True
    g.node_fixed[0] = True
    g.edge_i[:E] = torch.tensor(I, dtype=torch.int32)
    g.edge_j[:E] = torch.tensor(J, dtype=torch.int32)
    g.edge_meas[:E] = se3.inv(gt[I]) @ gt[J] @ noise
    g.edge_info[:E] = torch.eye(6) * 100.0
    g.edge_active[:E] = True
    _, it = optimize(g, iterations=30, solver="pcg", n_nodes=n, n_edges=E,
                     read_convergence=read_convergence)
    assert (it < 30) == read_convergence  # the host's read stops it early
    st = timing.span_stats()["optimize.lm"]
    assert st["count"] == it and set(st["parents"]) == {None}


@pytest.mark.parametrize("params", [DEFAULT, KEEP_ALL], ids=["host_decisions", "keep_all"])
def test_online_counters_equal_the_spans(sequence, params):
    pipe, st = _run(sequence, params)
    mgr = pipe.manager
    assert mgr.online_optimizes == st["optimize.online"]["count"] > 0
    assert mgr.online_lm_iterations == st["optimize.lm"]["parents"]["optimize.online"]["count"]
    per_call = mgr.online_lm_iterations / mgr.online_optimizes
    iters = params.get("online_optimizer_iterations", 3)
    if params is DEFAULT:  # one an entered node after the first, each stopping early or at 3
        assert mgr.online_optimizes == mgr.n_nodes - 1
        assert 1 <= per_call <= iters and mgr.solver_calls == {"dense": 0, "pcg": mgr.n_nodes - 1}
    else:  # every iteration runs, those after convergence masked
        assert per_call == iters
