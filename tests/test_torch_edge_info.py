"""Port parity: the Hessian edge information of tpu_edge_info=hessian.

* ops/registration.pose_information against the JAX function on
  numpy-seeded candidates (B=4, M=64; relative 1e-4 of the largest entry:
  float32 sums in another order).
* The keep-all step (device_step.slam_step, on the CPU): every frame's GN
  information, recorded inside compare_to_candidates, against the JAX
  pose_information of the same transforms, points and inliers, and every
  visual edge the step writes against the JAX step's formula
  (_compute_body: trace-matched to n_inliers / max(rmse^2, 1e-4), the
  scalar identity where the information is not finite or its trace is not
  positive), within 1e-4 relative.
* The default path (keep_all_nodes=False) with injected comparisons
  (tests/test_torch_decisions.py's pattern) whose GN information is
  numpy-made, some of it degenerate (zero, NaN): both managers write the
  same edges with the same information (atol 1e-3 on entries up to ~1e5,
  float32) and the frame pulls its comparison in one copy.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph import manager as jmanager  # noqa: E402
from rgbdslam_v2_tpu.graph.compare import CompareResult as JCompareResult  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.ops import registration as jreg  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.core.noise import point_covariance_diag  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import compare as tcompare  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import manager as tmanager  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.compare import CompareResult  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import registration  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 14
PARAMS = dict(max_keypoints=256, tpu_max_nodes=64, tpu_max_edges=512, tpu_candidate_batch=4,
              ransac_iterations=128, min_matches=12, optimizer_skip_step=10,
              observability_threshold=0.5, tpu_drain_pipelined=False, tpu_edge_info="hessian")


@pytest.fixture(scope="module")
def sequence():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=2)
    return np.asarray(poses), rgbs, depths


def _jax_info6(T, src, dst, inl, fx=525.0, fy=525.0):
    """The JAX package's per-candidate information (compare.py's info_one)."""
    from rgbdslam_v2_tpu.core.noise import point_covariance_diag as jcov

    def one(T, s, d, i):
        return jreg.pose_information(T, s, d, jcov(s[:, 2], fx, fy, 0.01),
                                     jcov(d[:, 2], fx, fy, 0.01), i)

    return np.asarray(jax.vmap(one)(*(jnp.asarray(a) for a in (T, src, dst, inl))))


def _close(got, ref, rtol=1e-4):
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(got - ref).max()) <= rtol * scale, float(np.abs(got - ref).max()) / scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_information_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, M = 4, 64
    src = np.stack([rng.uniform(-1.5, 1.5, (B, M)), rng.uniform(-1, 1, (B, M)),
                    rng.uniform(0.8, 5.0, (B, M))], -1).astype(np.float32)
    T = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.05, 6), jnp.float32)))
                  for _ in range(B)])
    dst = (src @ T[:, :3, :3].transpose(0, 2, 1) + T[:, None, :3, 3]
           + rng.normal(0, 0.005, src.shape)).astype(np.float32)
    inl = rng.uniform(size=(B, M)) < 0.7
    inl[3] = False  # no inlier: the zero matrix
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    got = registration.pose_information(
        torch.from_numpy(T), s, d, point_covariance_diag(s[..., 2], 525.0, 525.0, 0.01),
        point_covariance_diag(d[..., 2], 525.0, 525.0, 0.01), torch.from_numpy(inl)).numpy()
    ref = _jax_info6(T, src, dst, inl)
    for b in range(B):
        if b == 3:
            assert not got[b].any() and not ref[b].any()
        else:
            _close(got[b], ref[b])
            np.testing.assert_array_equal(got[b], got[b].T)
            assert np.linalg.eigvalsh(got[b].astype(np.float64)).min() > 0


def _formula(info6, n_inliers, rmse):
    """The JAX step's visual-edge information (device_step._compute_body)."""
    info_scale = n_inliers.astype(np.float32) / np.maximum(rmse * rmse, 1e-4)
    tr = np.trace(info6, axis1=-2, axis2=-1) / 6.0
    with np.errstate(all="ignore"):
        vis = info6 * (info_scale / np.maximum(tr, 1e-12))[:, None, None]
    ok = np.isfinite(vis).all(axis=(-2, -1)) & (tr > 0)
    return np.where(ok[:, None, None], vis, info_scale[:, None, None] * np.eye(6, dtype=np.float32))


def test_fast_path_hessian_matches_jax(sequence, monkeypatch):
    """keep_all_nodes: each step's information against the JAX function,
    each accepted visual edge against the JAX step's formula."""
    gt, rgbs, depths = sequence
    calls, results = [], []
    real_info, real_compare = tcompare.pose_information, tcompare.compare_to_candidates

    def recording_info(*a):
        out = real_info(*a)
        calls.append([x.numpy().copy() for x in (a[0], a[1], a[2], a[5], out)])
        return out

    def recording_compare(*a, **kw):
        res = real_compare(*a, **kw)
        results.append((res.n_inliers.numpy().copy(), res.rmse.numpy().copy()))
        return res

    monkeypatch.setattr(tcompare, "pose_information", recording_info)
    from rgbdslam_v2_tpu_torch.graph import device_step
    monkeypatch.setattr(device_step, "compare_to_candidates", recording_compare)
    mgr = tmanager.GraphManager(Intrinsics(*CAM),
                                ParameterServer(dict(PARAMS, keep_all_nodes=True)), device="cpu")
    for f in range(N_FRAMES):
        mgr.add_frame(rgbs[f], depths[f], f / 30.0, gt[0] if f == 0 else None)
    mgr.statistics()  # drain
    assert len(calls) == len(results) == N_FRAMES - 1
    B = PARAMS["tpu_candidate_batch"]
    n_checked = 0
    for k, ((T, src, dst, inl, info6), (n_inl, rmse)) in enumerate(zip(calls, results)):
        _close(info6, _jax_info6(T, src, dst, inl, CAM[0], CAM[1]))
        want = _formula(info6, n_inl, rmse)
        start = k * (B + 1)  # this frame's B visual edge slots
        for b in range(B):
            if mgr.host.edge_active[start + b]:  # accepted
                _close(mgr.graph.edge_info[start + b].numpy(), want[b])
                n_checked += 1
    assert n_checked >= N_FRAMES
    off = mgr.graph.edge_info[: mgr.n_edges].numpy()
    assert np.abs(off[:, 0, 1]).max() > 0  # anisotropic: not the scalar identity


def _results(gt, frame, cand_frames):
    """Numpy comparison results with GN information: SPD matrices, one
    all-zero (trace 0) and one NaN candidate fall back to the scalar."""
    rng = np.random.default_rng([7, frame])
    B = len(cand_frames)
    xi = np.concatenate([rng.normal(0, 0.002, (B, 3)), rng.normal(0, 0.01, (B, 3))], 1)
    T = np.linalg.inv(gt[cand_frames]) @ gt[frame] @ np.stack(
        [np.asarray(jse3.exp_se3(jnp.asarray(x, jnp.float32))) for x in xi])
    A = rng.normal(0, 1, (B, 6, 6))
    info6 = (A @ A.transpose(0, 2, 1) * rng.uniform(10, 1e4, (B, 1, 1))).astype(np.float32)
    info6[1] = 0.0
    info6[2, 3, 3] = np.nan
    return dict(transform=T.astype(np.float32), n_inliers=rng.integers(14, 200, B).astype(np.int32),
                rmse=rng.uniform(0.004, 0.03, B).astype(np.float32),
                ransac_ok=rng.uniform(size=B) > 0.1,
                emm_quality=rng.uniform(0.6, 1.0, B).astype(np.float32),
                emm_inlier_frac=rng.uniform(0.3, 1.0, B).astype(np.float32), info6=info6)


def test_default_path_hessian_matches_jax(sequence):
    gt, rgbs, depths = sequence
    params = dict(PARAMS, keep_all_nodes=False, tpu_candidate_batch=6)
    jm = jmanager.GraphManager(JIntrinsics(*CAM), JParams(dict(params)))
    tm = tmanager.GraphManager(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    clock = {}

    def frames_of(mgr, cand_idx):
        return [int(round(mgr.timestamps[int(c)] * 30)) for c in np.asarray(cand_idx)]

    def jax_compare(kp, depth_small, cand_idx, key):
        r = _results(gt, clock["frame"], frames_of(jm, cand_idx))
        B = len(r["rmse"])
        return JCompareResult(n_matches=np.zeros(B, np.int32), emm_all=np.zeros(B, np.int32),
                              **r)

    pulls = []
    real_unpack = tcompare.CompareSummary.unpack

    def port_compare(kp, depth_small, cand_idx):
        r = _results(gt, clock["frame"], frames_of(tm, cand_idx.cpu()))
        return CompareResult(**{k: torch.from_numpy(v) for k, v in r.items()})

    def counted_unpack(flat, B):
        pulls.append(flat.shape)
        return real_unpack(flat, B)

    jm._compare_dispatch = jax_compare
    tm._compare_dispatch = port_compare
    tcompare.CompareSummary.unpack = staticmethod(counted_unpack)
    try:
        for f in range(N_FRAMES):
            clock["frame"] = f
            g0 = gt[0] if f == 0 else None
            assert jm.add_frame(rgbs[f], depths[f], f / 30.0, g0) == tm.add_frame(
                rgbs[f], depths[f], f / 30.0, g0)
    finally:
        tcompare.CompareSummary.unpack = real_unpack
    assert len(pulls) == N_FRAMES - 1  # one copy a frame, info6 riding along
    assert all(s == (6 * 16 + 5 * 6 + 1 + 6 * 36,) for s in pulls)
    assert tm.n_edges == jm.n_edges and tm.host.edge_pairs == jm.edge_pairs
    got = tm.graph.edge_info[: tm.n_edges].numpy()
    ref = np.asarray(jm.graph.edge_info)[: jm.n_edges]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert np.abs(got[:, 0, 1]).max() > 0
    np.testing.assert_allclose(tm.poses(), jm.poses(), atol=1e-4)
