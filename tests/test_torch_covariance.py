"""Empirical edge information in the port (optim/covariance.py and
GraphManager.set_empirical_covariances) against the JAX package, at
160x120: the same GraphState (a JAX run's graph, with and without odometry
edges, carried across) gives information matrices within rtol 2e-3 of the
JAX function's (the (E, 6, 6) inverses of float32 covariances summed in
another order; atol 1e-3 of the information scale for entries near 0),
in row chunks of any size; inactive slots keep theirs bit for bit; and the
manager method changes the active edges' information as the JAX oracle
(tests/test_manager_extras.py) asserts.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph import odometry as jodometry  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.optim import covariance as jcov  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager  # noqa: E402
from rgbdslam_v2_tpu_torch.optim import covariance  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N = 10
BASE = dict(max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
            ransac_iterations=128, min_matches=12, optimizer_skip_step=100,
            keep_all_nodes=True, observability_threshold=0.5)


@pytest.fixture(scope="module", params=["visual", "odometry"])
def jax_manager(request):
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N, seed=2, depth_noise_sigma=0.01)
    stamps = np.arange(N) / 30.0
    pipe = JPipeline(JIntrinsics(*CAM), JParams(
        {**BASE, "use_robot_odom": request.param == "odometry"}))
    pipe.manager.set_odometry_provider(jodometry.OdometryProvider(stamps, np.asarray(poses)))
    pipe.run_arrays(rgbs, depths, stamps, gt_poses=np.asarray(poses))
    pipe.manager.optimize(blocking=True)
    return pipe.manager


def _close(got, want):
    scale = np.abs(want).max(axis=(-1, -2), keepdims=True)
    assert np.all(np.abs(got - want) <= 2e-3 * np.abs(want) + 1e-3 * scale), \
        np.abs(got - want).max()


@pytest.mark.parametrize("bandwidth", [0.1, 0.5])
def test_information_matches_jax(jax_manager, bandwidth, monkeypatch):
    jg = jax_manager.graph
    want = np.asarray(jcov.empirical_information(jg, bandwidth=bandwidth))
    g = interop.graph_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})
    active = g.edge_active.numpy()
    assert active.sum() > 10
    for rows in (1024, 7):
        monkeypatch.setattr(covariance, "ROW_CHUNK", rows)
        for n_edges in (None, jax_manager.n_edges):
            got = covariance.empirical_information(g, bandwidth=bandwidth, n_edges=n_edges).numpy()
            _close(got[active], want[active])
            np.testing.assert_array_equal(got[~active], g.edge_info.numpy()[~active])


def test_manager_sets_empirical_covariances(jax_manager, tmp_path):
    """The JAX oracle's assertions in the port (a checkpoint of the JAX run
    loaded): the active edges' information changes, keeps positive
    diagonals, and the inactive slots stay as they were."""
    jax_manager.save_state(tmp_path / "state.npz")
    tm = GraphManager(Intrinsics(*CAM), ParameterServer(dict(BASE)), device="cpu")
    tm.load_state(tmp_path / "state.npz")
    active = tm.graph.edge_active.numpy()
    before = tm.graph.edge_info.numpy().copy()
    tm.set_empirical_covariances()
    after = tm.graph.edge_info.numpy()
    assert not np.allclose(before[active], after[active])
    assert (np.einsum("eii->e", after[active]) > 0).all()
    np.testing.assert_array_equal(after[~active], before[~active])
    _close(after[active], np.asarray(jcov.empirical_information(jax_manager.graph))[active])
