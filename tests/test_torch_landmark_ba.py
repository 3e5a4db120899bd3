"""Landmark bundle adjustment in the port (optim/landmark_ba.py and
GraphManager.optimize_landmarks) against the JAX package.

On tests/test_landmark_ba.py's problems (5 poses on an arc, 40 landmarks,
noisy poses and landmarks, built here by the JAX package): the port's
optimize_landmarks gives the JAX function's poses within 1e-4 m and 1e-4
rad-scale entries and its landmarks within 1e-4 m after 5 rounds, and
chi2 within rtol 1e-4; over 40 rounds it recovers the geometry as the JAX
oracle asserts. The manager method on one JAX checkpoint (12 frames at
160x120) loaded into both packages: equal landmarks and observations, chi2
before and after within rtol 1e-4, poses within 1e-4 m.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import GraphManager as JManager  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.optim import landmark_ba as jba  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager  # noqa: E402
from rgbdslam_v2_tpu_torch.optim import landmark_ba  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
BASE = dict(max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
            ransac_iterations=128, min_matches=12, optimizer_skip_step=100,
            keep_all_nodes=True, observability_threshold=0.5)


def _jax_problem(seed=0, n_poses=5, n_lm=40, pose_noise=0.03, lm_noise=0.05):
    """tests/test_landmark_ba.py's _make_problem."""
    cam = JIntrinsics(*CAM)
    rng = np.random.default_rng(seed)
    gt_poses = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(
        np.array([0.15 * k, 0.02 * k, 0.0, 0.0, 0.05 * k, 0.0], np.float32))))
        for k in range(n_poses)])
    gt_lm = np.stack([rng.uniform(-1.5, 2.0, n_lm), rng.uniform(-1.0, 1.0, n_lm),
                      rng.uniform(2.0, 4.0, n_lm)], -1).astype(np.float32)
    obs_lm, obs_pose, obs_uvz = [], [], []
    for p in range(n_poses):
        Tcw = np.asarray(jse3.inv(jnp.asarray(gt_poses[p])))
        pc = gt_lm @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        u = pc[:, 0] / z * cam.fx + cam.cx
        v = pc[:, 1] / z * cam.fy + cam.cy
        vis = (z > 0.5) & (u > 0) & (u < 160) & (v > 0) & (v < 120)
        for lm in np.nonzero(vis)[0]:
            obs_lm.append(lm)
            obs_pose.append(p)
            obs_uvz.append([u[lm], v[lm], z[lm]])
    O = len(obs_lm)
    g = jba.make_landmark_graph(n_poses, n_lm, O)
    noisy = np.stack([gt_poses[k] @ np.asarray(jse3.exp_se3(jnp.asarray(
        rng.normal(0, pose_noise, 6).astype(np.float32)))) if k > 0 else gt_poses[k]
        for k in range(n_poses)])
    g = g._replace(
        poses=jnp.asarray(noisy), pose_fixed=g.pose_fixed.at[0].set(True),
        landmarks=jnp.asarray(gt_lm + rng.normal(0, lm_noise, gt_lm.shape).astype(np.float32)),
        lm_active=jnp.ones(n_lm, bool), obs_lm=jnp.asarray(obs_lm, jnp.int32),
        obs_pose=jnp.asarray(obs_pose, jnp.int32),
        obs_uvz=jnp.asarray(np.asarray(obs_uvz, np.float32)), obs_active=jnp.ones(O, bool))
    return g, gt_poses, gt_lm


def _port(g) -> landmark_ba.LandmarkGraph:
    a = {k: torch.from_numpy(np.array(v)) for k, v in g._asdict().items()}
    a["obs_lm"], a["obs_pose"] = a["obs_lm"].long(), a["obs_pose"].long()
    return landmark_ba.LandmarkGraph(**a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_landmarks_matches_jax(seed):
    g, _, _ = _jax_problem(seed)
    cam, tcam = JIntrinsics(*CAM), Intrinsics(*CAM)
    want = jba.optimize_landmarks(g, cam, iterations=5)
    got = landmark_ba.optimize_landmarks(_port(g), tcam, iterations=5)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-4)
    np.testing.assert_allclose(got.landmarks.numpy(), np.asarray(want.landmarks), atol=1e-4)
    for a, b in ((g, _port(g)), (want, got)):
        np.testing.assert_allclose(float(landmark_ba.chi2(b, tcam)), float(jba.chi2(a, cam)),
                                   rtol=1e-4)


def test_perturbation_recovery():
    """tests/test_landmark_ba.py's oracle bounds, in the port: chi2 falls by
    1e3, the poses come within 1 cm and the landmarks' median within 1 cm;
    the fixed pose stays; with no active observation nothing moves."""
    g, gt_poses, gt_lm = _jax_problem()
    tcam = Intrinsics(*CAM)
    tg = _port(g)
    g2 = landmark_ba.optimize_landmarks(tg, tcam, iterations=40)
    assert float(landmark_ba.chi2(g2, tcam)) < float(landmark_ba.chi2(tg, tcam)) * 1e-3
    assert np.linalg.norm(g2.poses.numpy()[:, :3, 3] - gt_poses[:, :3, 3], axis=-1).max() < 0.01
    assert np.median(np.linalg.norm(g2.landmarks.numpy() - gt_lm, axis=-1)) < 0.01
    np.testing.assert_allclose(g2.poses[0].numpy(), tg.poses[0].numpy(), atol=1e-6)
    off = tg.replace(obs_active=torch.zeros_like(tg.obs_active))
    g3 = landmark_ba.optimize_landmarks(off, tcam, iterations=3)
    np.testing.assert_allclose(g3.poses.numpy(), off.poses.numpy(), atol=1e-5)
    np.testing.assert_allclose(g3.landmarks.numpy(), off.landmarks.numpy(), atol=1e-5)


def test_manager_landmark_ba_on_one_checkpoint(tmp_path):
    """One JAX checkpoint loaded into both packages' managers: the re-match,
    tracks and observation table are the same, so are the landmark and
    observation counts; chi2 before and after within rtol 1e-4; the
    written-back poses within 1e-4 m."""
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, 12, seed=2)
    jp = JPipeline(JIntrinsics(*CAM), JParams(dict(BASE)))
    jp.run_arrays(rgbs, depths, np.arange(12) / 30.0, gt_poses=np.asarray(poses))
    jp.manager.save_state(tmp_path / "state.npz")
    jm = JManager(JIntrinsics(*CAM), JParams(dict(BASE)))
    jm.load_state(tmp_path / "state.npz")
    tm = GraphManager(Intrinsics(*CAM), ParameterServer(dict(BASE)), device="cpu")
    tm.load_state(tmp_path / "state.npz")
    want, got = jm.optimize_landmarks(), tm.optimize_landmarks()
    assert want["landmarks"] > 100
    assert (got["landmarks"], got["observations"]) == (want["landmarks"], want["observations"])
    for key in ("chi2_before", "chi2_after"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert got["chi2_after"] < got["chi2_before"]
    np.testing.assert_allclose(tm.poses(), jm.poses(), atol=1e-4)
