"""Robot odometry in the port (graph/odometry.py and GraphManager's
use_robot_odom / use_robot_odom_only) against the JAX package, at 160x120
on tests/test_manager_extras.py's 12-frame sequence, with the ground-truth
poses as odometry.

OdometryProvider's lookup and delta within 1e-6 of the JAX one; the
odometry-only trajectory within 1e-3 m of ground truth and 1e-5 m of the JAX
package's, every edge EDGE_ODOMETRY; visual + odometry edges, an odometry
edge a frame, on the host path and with keep_all_nodes (which the odometry
keeps off the device fast path); RuntimeError without a provider; a JAX
checkpoint holding odometry edges loads into the port with its edge types.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph import odometry as jodometry  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import EDGE_ODOMETRY as J_EDGE_ODOMETRY  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import odometry  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_ODOMETRY  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import fast_path  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N = 12
# tests/test_manager_extras.py's _params
BASE = dict(max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
            ransac_iterations=128, min_matches=12, optimizer_skip_step=100,
            keep_all_nodes=True, observability_threshold=0.5)


@pytest.fixture(scope="module")
def seq():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N, seed=2)
    return np.asarray(poses), np.asarray(rgbs), np.asarray(depths), np.arange(N) / 30.0


def _pipes(seq, frames=N, **over):
    """Both packages' pipelines on the first `frames` frames with the
    ground truth as odometry."""
    poses, rgbs, depths, stamps = seq
    jp = JPipeline(JIntrinsics(*CAM), JParams({**BASE, **over}))
    jp.manager.set_odometry_provider(jodometry.OdometryProvider(stamps, poses))
    tp = SlamPipeline(Intrinsics(*CAM), ParameterServer({**BASE, **over}), device="cpu")
    tp.manager.set_odometry_provider(odometry.OdometryProvider(stamps, poses))
    for pipe in (jp, tp):
        pipe.run_arrays(rgbs[:frames], depths[:frames], stamps[:frames], gt_poses=poses)
    return jp.manager, tp.manager


@pytest.mark.parametrize("seed", range(3))
def test_lookup_and_delta_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 9
    stamps = np.sort(rng.uniform(0.0, 3.0, n))
    xi = rng.normal(0, 0.4, (n, 6)).astype(np.float32)
    from rgbdslam_v2_tpu_torch.core import se3

    poses = se3.exp_se3(torch.from_numpy(xi)).numpy()
    jp, tp = jodometry.OdometryProvider(stamps, poses), odometry.OdometryProvider(stamps, poses)
    for t in [-0.6, -0.2, *rng.uniform(-0.3, 3.3, 20), stamps[3], 3.4, 4.0]:
        a, b = jp.lookup(t), tp.lookup(t)
        assert (a is None) == (b is None), t
        if a is not None:
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)
    for t0, t1 in rng.uniform(-0.2, 3.2, (20, 2)):
        a, b = jp.delta(t0, t1), tp.delta(t0, t1)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)
    np.testing.assert_array_equal(odometry.odometry_information(0.1, 1e6),
                                  jodometry.odometry_information(0.1, 1e6))


def test_odometry_only_trajectory(seq):
    poses = seq[0]
    jm, tm = _pipes(seq, use_robot_odom_only=True)
    assert tm.n_nodes == jm.n_nodes == N
    est = tm.poses()
    np.testing.assert_allclose(est[:, :3, 3], poses[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(est[:, :3, 3], jm.poses()[:, :3, 3], atol=1e-5)
    assert tm.host.edge_types == jm.edge_types == [EDGE_ODOMETRY] * (N - 1)
    assert EDGE_ODOMETRY == J_EDGE_ODOMETRY
    assert tm.statistics() == {**jm.statistics(), "icp_rescues": 0}


@pytest.mark.parametrize("over", [{}, {"tpu_frames_per_step": 4}, {"keep_all_nodes": False}],
                         ids=["keep_all", "four_a_step", "host_path"])
def test_visual_plus_odometry_edges(seq, over):
    """Mixed edge types: every frame after the first gets an odometry edge
    beside its visual ones, as in the JAX package. With keep_all_nodes the
    odometry keeps the frames off the device fast path (they would lose
    their odometry edge there), one frame a step or four."""
    jm, tm = _pipes(seq, frames=8, use_robot_odom=True, **over)
    assert not fast_path(tm.params)
    types = tm.host.edge_types
    assert types.count(EDGE_ODOMETRY) == jm.edge_types.count(EDGE_ODOMETRY) == tm.n_nodes - 1
    assert any(t != EDGE_ODOMETRY for t in types)
    assert tm.n_nodes == jm.n_nodes
    np.testing.assert_allclose(tm.poses()[:, :3, 3], jm.poses()[:, :3, 3], atol=0.02)


def test_odometry_only_needs_a_provider(seq):
    poses, rgbs, depths, stamps = seq
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer({**BASE, "use_robot_odom_only": True}),
                        device="cpu")
    pipe.process_frame(rgbs[0], depths[0], float(stamps[0]), poses[0])
    with pytest.raises(RuntimeError, match="odometry provider"):
        pipe.process_frame(rgbs[1], depths[1], float(stamps[1]))


def test_jax_checkpoint_with_odometry_edges_loads(seq, tmp_path):
    """A JAX checkpoint whose graph holds odometry edges loads into the port
    (interop: the edge types, the odometry edges' measurements and
    information) and its g2o export equals the JAX package's."""
    jm, _ = _pipes(seq, frames=6, use_robot_odom=True)
    jm.save_state(tmp_path / "state.npz")
    tp = SlamPipeline(Intrinsics(*CAM), ParameterServer({**BASE, "use_robot_odom": True}),
                      device="cpu")
    tp.manager.load_state(tmp_path / "state.npz")
    assert tp.manager.host.edge_types == jm.edge_types
    assert EDGE_ODOMETRY in tp.manager.host.edge_types
    np.testing.assert_array_equal(tp.manager.graph.edge_info.numpy(),
                                  np.asarray(jm.graph.edge_info))
    jp = JPipeline(JIntrinsics(*CAM), JParams({**BASE, "use_robot_odom": True}))
    jp.manager = jm
    jp.save_g2o(tmp_path / "jax.g2o")
    tp.save_g2o(tmp_path / "port.g2o")
    assert (tmp_path / "port.g2o").read_text() == (tmp_path / "jax.g2o").read_text()
