"""Port parity: the exact EMM of tpu_emm_exact and the EMM toolbox
(ops/emm.py: observation_likelihood_exact, pairwise_observation_likelihood,
rejection_significance, observation_criterion_met) against the JAX package
on tests/test_emm.py's scenes: two rendered 160x120 frames of the synthetic
world, a flat wall and a depth step edge.

Counts are integers over the same projected pixels, so they are compared
exactly; the quality ratio within 1e-6; the chi^2 p-value within 1e-5
(torch.special.gammainc against jax.scipy's). The batched port takes
several transforms in one call where the JAX function takes one.
compare_to_candidates with emm_exact (the candidates' full depth rows
from the store) is held to the JAX function in
tests/test_torch_edge_info.py's pipeline runs and in test_torch_slice.py.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.core.camera import backproject_grid as jbackproject  # noqa: E402
from rgbdslam_v2_tpu.core.frames import make_frame  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld  # noqa: E402
from rgbdslam_v2_tpu.ops import emm as jemm  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import emm  # noqa: E402

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)


@pytest.fixture(scope="module")
def frames():
    """tests/test_emm.py's _two_frames: frames 0 and 1 of the orbit and the
    true a_T_b, as numpy."""
    cam = JIntrinsics(*CAM)
    world = JWorld.create(seed=0, texture_size=128, cam=cam)
    poses = world.orbit_trajectory(60, seed=2)
    out = []
    for T in (poses[0], poses[1]):
        rgb, depth = world.render(T)
        f = make_frame((rgb * 255).astype(jnp.uint8), depth, cam)
        out.append(tuple(np.asarray(a) for a in (f.points, f.valid, f.depth)))
    return out[0], out[1], np.asarray(jse3.relative(poses[0], poses[1]))


def _transforms(a_T_b):
    """The true transform, a gross misregistration and half a metre of
    depth error (tests/test_emm.py's three)."""
    bad = a_T_b @ np.asarray(jse3.exp_se3(jnp.asarray([1.2, 0.0, -0.72, 0.0, 0.9, 0.0],
                                                      jnp.float32)))
    deep = a_T_b.copy()
    deep[2, 3] += 0.5
    return np.stack([a_T_b, bad, deep]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_result(got, refs):
    for b, ref in enumerate(refs):
        for name in ("inliers", "outliers", "occluded", "all_projected"):
            assert int(getattr(got, name)[b]) == int(getattr(ref, name)), (b, name)
        np.testing.assert_allclose(float(got.quality[b]), float(ref.quality), atol=1e-6)


@pytest.mark.parametrize("skip", [1, 2, 3])
@pytest.mark.parametrize("cov_scale", [1.0, 2.0])
def test_exact_matches_jax_on_rendered_frames(frames, skip, cov_scale):
    (_, _, depth_a), (pts_b, val_b, _), a_T_b = frames
    Ts = _transforms(a_T_b)
    cam = Intrinsics(*CAM)
    got = emm.observation_likelihood_exact(_t(Ts), _t(pts_b)[None], _t(val_b)[None],
                                           _t(depth_a)[None], cam, skip, 0.01,
                                           cov_scale=cov_scale)
    refs = [jemm.observation_likelihood_exact(jnp.asarray(T), jnp.asarray(pts_b),
                                              jnp.asarray(val_b), jnp.asarray(depth_a),
                                              JIntrinsics(*CAM), skip, 0.01, cov_scale=cov_scale)
            for T in Ts]
    _assert_result(got, refs)
    assert int(got.all_projected[0]) > 500


@pytest.mark.parametrize("scene", ["flat", "step"])
def test_exact_matches_jax_on_flat_and_step_scenes(scene):
    """test_emm.py's flat wall and step edge (64x48): exact counts equal,
    and the pooled path's inliers a superset of the exact path's."""
    w, h = 64, 48
    jcam = JIntrinsics(fx=50.0, fy=50.0, cx=w / 2, cy=h / 2, width=w, height=h)
    cam = Intrinsics(fx=50.0, fy=50.0, cx=w / 2, cy=h / 2, width=w, height=h)
    if scene == "flat":
        old = np.full((h, w), 2.0, np.float32)
    else:
        old = np.where(np.arange(w)[None, :] < w // 2, 1.0, 3.0).astype(np.float32) * np.ones(
            (h, w), np.float32)
    new = np.full((h, w), 2.0, np.float32)
    pts = np.asarray(jbackproject(jnp.asarray(new), jcam))
    val = new > 0
    T = np.eye(4, dtype=np.float32)[None]
    got = emm.observation_likelihood_exact(_t(T), _t(pts)[None], _t(val)[None], _t(old)[None],
                                           cam)
    ref = jemm.observation_likelihood_exact(jnp.eye(4), jnp.asarray(pts), jnp.asarray(val),
                                            jnp.asarray(old), jcam)
    _assert_result(got, [ref])
    pool = emm.observation_likelihood_dense(_t(T), _t(pts)[None], _t(val)[None], _t(old)[None],
                                            cam)
    assert int(pool.inliers[0]) >= int(got.inliers[0])
    if scene == "step":
        assert int(got.inliers[0]) == 0 and int(got.occluded[0]) > 0
        assert int(got.outliers[0]) > 0


@pytest.mark.parametrize("skip", [1, 2])
def test_pairwise_matches_jax(frames, skip):
    (pts_a, val_a, depth_a), (pts_b, val_b, depth_b), a_T_b = frames
    Ts = _transforms(a_T_b)
    b_T_a = np.stack([np.linalg.inv(T) for T in Ts]).astype(np.float32)
    got = emm.pairwise_observation_likelihood(
        _t(b_T_a), _t(pts_b)[None], _t(val_b)[None], _t(depth_b)[None], _t(pts_a)[None],
        _t(val_a)[None], _t(depth_a)[None], Intrinsics(*CAM), skip)
    refs = [jemm.pairwise_observation_likelihood(
        jnp.asarray(T), jnp.asarray(pts_b), jnp.asarray(val_b), jnp.asarray(depth_b),
        jnp.asarray(pts_a), jnp.asarray(val_a), jnp.asarray(depth_a), JIntrinsics(*CAM), skip)
        for T in b_T_a]
    _assert_result(got, refs)
    assert float(got.quality[0]) > 0.9


def test_rejection_significance_matches_jax(frames):
    (_, _, depth_a), (pts_b, val_b, _), a_T_b = frames
    Ts = _transforms(a_T_b)
    got = emm.rejection_significance(_t(Ts), _t(pts_b)[None], _t(val_b)[None],
                                     _t(depth_a)[None], Intrinsics(*CAM))
    refs = [float(jemm.rejection_significance(jnp.asarray(T), jnp.asarray(pts_b),
                                              jnp.asarray(val_b), jnp.asarray(depth_a),
                                              JIntrinsics(*CAM))) for T in Ts]
    np.testing.assert_allclose(got.numpy(), refs, atol=1e-5)
    assert float(got[2]) > 0.999 and float(got[2]) > float(got[0])


@pytest.mark.parametrize("threshold", [0.0, 0.5, 0.9])
def test_criterion_matches_jax(frames, threshold):
    (_, _, depth_a), (pts_b, val_b, _), a_T_b = frames
    Ts = _transforms(a_T_b)
    got = emm.observation_likelihood_exact(_t(Ts), _t(pts_b)[None], _t(val_b)[None],
                                           _t(depth_a)[None], Intrinsics(*CAM))
    met = emm.observation_criterion_met(got, threshold)
    for b, T in enumerate(Ts):
        ref = jemm.observation_likelihood_exact(jnp.asarray(T), jnp.asarray(pts_b),
                                                jnp.asarray(val_b), jnp.asarray(depth_a),
                                                JIntrinsics(*CAM))
        assert bool(met[b]) == bool(jemm.observation_criterion_met(ref, threshold))
    assert bool(met[0])
