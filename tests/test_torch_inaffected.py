"""Port parity for pose_relative_to=inaffected: the subgraph the JAX
package's `_optimize_inaffected` hands to `_inaffected_kernel` (captured by
replacing the module attribute for the test), the optimized poses, and the
watermark rules of `optimize`.

The subgraph (node and edge ids, local endpoints, padding and masks) must
be equal exactly; the poses after the optimize agree to atol 1e-4 (float32,
other summation order). The watermark sequence over a keep-all run (online
optimizes leave the 2 newest summaries pending) and after a blocking call
must be equal exactly.
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
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import manager as tmanager  # noqa: E402

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N, E = 40, 120
PARAMS = dict(max_keypoints=128, tpu_max_nodes=64, tpu_max_edges=256, tpu_candidate_batch=4,
              pose_relative_to="inaffected", tpu_drain_pipelined=False)


def _exp(xi):
    return np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _managers(solver):
    """A JAX and a port manager holding the same 40-node graph: a noisy
    chain plus loop edges, four edges deactivated."""
    params = dict(PARAMS, backend_solver=solver)
    jm = jmanager.GraphManager(JIntrinsics(*CAM), JParams(dict(params)))
    tm = tmanager.GraphManager(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    rng = np.random.default_rng(0)
    gt = _exp(np.cumsum(rng.normal(0, 0.1, (N, 6)), 0))
    pairs = [(i, i + 1) for i in range(N - 1)]
    while len(pairs) < E:
        i, j = sorted(rng.choice(N, 2, replace=False))
        pairs.append((int(i), int(j)))
    ei = np.array([p[0] for p in pairs], np.int32)
    ej = np.array([p[1] for p in pairs], np.int32)
    meas = np.linalg.inv(gt[ei]) @ gt[ej] @ _exp(rng.normal(0, 0.01, (E, 6)))
    active = np.ones(E, bool)
    active[[5, 44, 70, 101]] = False
    g = jm.graph
    jm.graph = g._replace(
        poses=g.poses.at[:N].set((gt @ _exp(rng.normal(0, 0.03, (N, 6)))).astype(np.float32)),
        node_active=g.node_active.at[:N].set(True),
        edge_i=g.edge_i.at[:E].set(ei), edge_j=g.edge_j.at[:E].set(ej),
        edge_meas=g.edge_meas.at[:E].set(meas.astype(np.float32)),
        edge_info=g.edge_info.at[:E].set(
            (np.eye(6) * rng.uniform(10, 1000, (E, 1, 1))).astype(np.float32)),
        edge_active=g.edge_active.at[:E].set(active),
    )
    jm.n_nodes, jm.n_edges = N, E
    jm.edge_i_host[:E], jm.edge_j_host[:E], jm.edge_active_host[:E] = ei, ej, active
    tm.graph = interop.graph_from_numpy({k: np.asarray(v) for k, v in jm.graph._asdict().items()})
    tm.host.n_nodes, tm.host.n_edges = N, E
    tm.host.edge_i[:E], tm.host.edge_j[:E], tm.host.edge_active[:E] = ei, ej, active
    return jm, tm


def _capture(monkeypatch, module, store):
    real = module._inaffected_kernel

    def spy(*args, **kw):
        store.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, "_inaffected_kernel", spy)


@pytest.mark.parametrize("solver, watermark", [("auto", 30), ("pcg", 30), ("auto", 0)])
def test_inaffected_subgraph_and_poses_match_jax(monkeypatch, solver, watermark):
    """watermark 0: no border node, so the subgraph's oldest node is fixed."""
    jm, tm = _managers(solver)
    jm._nodes_opt_watermark = tm._nodes_opt_watermark = watermark
    before = tm.poses()
    jcalls, tcalls = [], []
    _capture(monkeypatch, jmanager, jcalls)
    _capture(monkeypatch, tmanager, tcalls)
    jchi2 = jm._optimize_inaffected(3, True, 24)
    tchi2 = tm._optimize_inaffected(3, True, 24)
    (jargs, jkw), = jcalls
    (targs, tkw), = tcalls
    names = ("gi", "ge", "li", "lj", "nfix", "nact", "eact", "free_mask")
    for name, ja, ta in zip(names, jargs[1:], targs[1:]):
        ja, ta = np.asarray(ja), ta.numpy()
        assert ta.shape == ja.shape and ta.dtype.kind == ja.dtype.kind, name
        np.testing.assert_array_equal(ta, ja, err_msg=name)
    assert tkw["solver"] == jkw["solver"] == ("pcg" if solver == "pcg" else "dense")
    assert (tkw["iterations"], tkw["pcg_iters"]) == (jkw["iterations"], jkw["pcg_iters"])
    np.testing.assert_allclose(tm.poses(), jm.poses(), atol=1e-4)
    np.testing.assert_allclose(tchi2, jchi2, rtol=1e-3)
    moved = ~np.all(tm.poses() == before, axis=(1, 2))
    gi, nfix = np.asarray(jargs[1]), np.asarray(jargs[5])
    assert moved.any() and not moved[gi[nfix]].any()  # the border stays put


def test_inaffected_with_no_affected_edge_is_a_no_op():
    jm, tm = _managers("auto")
    jm._nodes_opt_watermark = tm._nodes_opt_watermark = N
    before = tm.poses()
    assert tm._optimize_inaffected(3, True, 24) == jm._optimize_inaffected(3, True, 24) == 0.0
    np.testing.assert_array_equal(tm.poses(), before)


@pytest.fixture(scope="module")
def sequence():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, 9, seed=2)
    return np.asarray(poses), rgbs, depths


def test_watermark_after_online_and_blocking_optimize(sequence):
    """Keep-all fast path, an online optimize every frame: the watermark
    stops at the oldest still-pending node; a blocking optimize drains all
    and moves it to n_nodes. Both packages, frame by frame."""
    poses, rgbs, depths = sequence
    params = dict(PARAMS, keep_all_nodes=True, optimizer_skip_step=1, ransac_iterations=64,
                  min_matches=12, tpu_drain_interval=4)
    jm = jmanager.GraphManager(JIntrinsics(*CAM), JParams(dict(params)))
    tm = tmanager.GraphManager(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    marks = []
    for i in range(len(rgbs)):
        gt = poses[0] if i == 0 else None
        jm.add_frame(rgbs[i], depths[i], i / 30.0, gt)
        tm.add_frame(rgbs[i], depths[i], i / 30.0, gt)
        marks.append((tm._nodes_opt_watermark, jm._nodes_opt_watermark))
    assert [t for t, _ in marks] == [j for _, j in marks]
    assert [t for t, _ in marks][2:] == list(range(1, len(rgbs) - 1))  # oldest pending
    assert len(tm._pending) == len(jm._pending) == 2
    tm.optimize(blocking=True)
    jm.optimize(blocking=True)
    assert tm._nodes_opt_watermark == jm._nodes_opt_watermark == len(rgbs)
    assert tm._pending == [] and jm._pending == []


def test_watermark_ignores_staged_drains_as_jax_does(sequence, monkeypatch):
    """Pipelined drains whose staged copies never land (the port's
    `_landed` and the JAX arrays' `is_ready` both report them in flight),
    an online optimize every frame: the watermark counts the pending nodes
    only, as the JAX package's does, so nodes staged but unread lie below
    it. Both packages, frame by frame (ROADMAP F10)."""
    poses, rgbs, depths = sequence
    params = dict(PARAMS, keep_all_nodes=True, optimizer_skip_step=1, ransac_iterations=64,
                  min_matches=12, tpu_drain_interval=4, tpu_drain_pipelined=True)
    monkeypatch.setattr(tmanager.GraphManager, "_landed", staticmethod(lambda event: False))
    monkeypatch.setattr(type(jnp.zeros(1)), "is_ready", lambda self: False)
    jm = jmanager.GraphManager(JIntrinsics(*CAM), JParams(dict(params)))
    tm = tmanager.GraphManager(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    marks, staged_below = [], 0
    for i in range(len(rgbs)):
        gt = poses[0] if i == 0 else None
        jm.add_frame(rgbs[i], depths[i], i / 30.0, gt)
        tm.add_frame(rgbs[i], depths[i], i / 30.0, gt)
        marks.append((tm._nodes_opt_watermark, jm._nodes_opt_watermark))
        staged = [e[0] for b in tm._staged for e in b[0]]
        assert staged == [e[0] for b in jm._staged_drains for e in b[0]]
        staged_below += bool(staged) and min(staged) < tm._nodes_opt_watermark
    assert [t for t, _ in marks] == [j for _, j in marks]
    assert staged_below > 0  # a rule counting staged nodes would stop lower
    tm.optimize(blocking=True)
    jm.optimize(blocking=True)
    assert tm._nodes_opt_watermark == jm._nodes_opt_watermark == len(rgbs)
    assert not tm._staged and not jm._staged_drains
