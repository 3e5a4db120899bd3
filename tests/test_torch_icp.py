"""The port's dense ICP (rgbdslam_v2_tpu_torch/ops/icp.py) against the JAX
package's (rgbdslam_v2_tpu/ops/icp.py) on the same numpy inputs: the
views of tests/test_icp.py (a 160x120 room corner and an orbit step),
rendered once by the JAX package.

Tolerances: normals and the 3x3 inverse within float32 rounding (1e-5 of
unit vectors, 1e-4 relative); ICP transforms within 1e-4 in rotation and
1e-4 m in translation, n_pairs within 1% and converged equal (the
brute-force nearest neighbour sums three float32 products in another
order than XLA, which can move a near-tie)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.core.camera import backproject_grid as jbackproject_grid  # noqa: E402
from rgbdslam_v2_tpu.core.frames import make_frame  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld  # noqa: E402
from rgbdslam_v2_tpu.ops import icp as jicp  # noqa: E402

from rgbdslam_v2_tpu_torch.core.camera import Intrinsics, backproject_grid  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import icp  # noqa: E402

CAM = Intrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120)
PERT = [0.02, -0.015, 0.02, 0.015, -0.02, 0.01]  # ~3 cm / 2 deg, as tests/test_icp.py


def _corner_pose(world, jitter=(0.0, 0.0, 0.0)):
    Lx, Ly, Lz = world.extent
    pos = jnp.asarray([Lx * 0.55 + jitter[0], Ly * 0.55 + jitter[1], Lz * 0.5 + jitter[2]])
    fwd = -pos / jnp.linalg.norm(pos)
    right = jnp.cross(fwd, jnp.asarray([0.0, 0.0, 1.0]))
    right = right / jnp.linalg.norm(right)
    down = jnp.cross(fwd, right)
    return jse3.from_rt(jnp.stack([right, down, fwd], axis=-1), pos)


@pytest.fixture(scope="module")
def views():
    """{"corner" | "orbit": (frame a, frame b, a_T_b)} as numpy arrays."""
    world = SyntheticWorld.create(seed=0, texture_size=128, cam=CAM)
    poses = world.orbit_trajectory(60, seed=2)
    out = {}
    for name, (Ta, Tb) in {"corner": (_corner_pose(world),
                                      _corner_pose(world, jitter=(0.04, -0.03, 0.02))),
                           "orbit": (poses[0], poses[1])}.items():
        frames = []
        for T in (Ta, Tb):
            rgb, depth = world.render(T)
            f = make_frame((rgb * 255).astype(jnp.uint8), depth, CAM)
            frames.append((np.asarray(f.points), np.asarray(f.valid), np.asarray(depth)))
        out[name] = (*frames, np.asarray(jse3.relative(Ta, Tb)))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def test_backproject_grid_matches_jax(views):
    (_, _, depth), _, _ = views["corner"]
    depth = depth.copy()
    depth[0, :3] = [np.nan, -1.0, np.inf]
    want = np.asarray(jbackproject_grid(jnp.asarray(depth), CAM))
    got = backproject_grid(_t(depth), CAM).numpy()
    np.testing.assert_array_equal(got, want)  # same float32 operations: bitwise


def test_grid_normals_match_jax(views):
    (pts, valid, _), _, _ = views["orbit"]
    want = np.asarray(jicp.grid_normals(jnp.asarray(pts), jnp.asarray(valid)))
    got = icp.grid_normals(_t(pts), _t(valid)).numpy()
    np.testing.assert_array_equal(np.abs(got) > 0, np.abs(want) > 0)  # same mask
    np.testing.assert_allclose(got, want, atol=1e-5)  # unit vectors, float32 rounding


def test_inv3x3_sym_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(32, 3, 3)).astype(np.float32)
    C = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(3, dtype=np.float32)
    want = np.asarray(jicp._inv3x3_sym(jnp.asarray(C)))
    got = icp._inv3x3_sym(_t(C)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)  # float32 adjugate


def _check(got, want, a_T_b=None):
    got = icp.IcpResult(*(x[0] for x in got))  # the batch of one
    T, Tj = got.transform.numpy(), np.asarray(want.transform)
    np.testing.assert_allclose(T[:3, :3], Tj[:3, :3], atol=1e-4)  # rotation entries
    np.testing.assert_allclose(T[:3, 3], Tj[:3, 3], atol=1e-4)  # metres
    n, nj = int(got.n_pairs), int(want.n_pairs)
    assert abs(n - nj) <= 0.01 * nj, (n, nj)  # n_pairs within 1%
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), rtol=1e-2)
    if a_T_b is not None:  # and the port does the job: within the JAX test's bound
        assert np.linalg.norm(np.linalg.inv(a_T_b) @ T - np.eye(4)) < 0.03


@pytest.mark.parametrize("variant", ["gicp", "point_to_plane"])
@pytest.mark.parametrize("start", ["perturbed", "truth"])
def test_icp_matches_jax(views, variant, start):
    """From a perturbed seed (corner view, 15 iterations) and at the truth
    (orbit step, 5 iterations), as tests/test_icp.py runs them."""
    name, iters = ("corner", 15) if start == "perturbed" else ("orbit", 5)
    (pa, va, _), (pb, vb, _), a_T_b = views[name]
    T0 = a_T_b.astype(np.float32)
    if start == "perturbed":
        T0 = T0 @ np.asarray(jse3.exp_se3(jnp.asarray(PERT, jnp.float32)))
    jfn = jicp.icp_plane_to_plane if variant == "gicp" else jicp.icp_point_to_plane
    tfn = icp.icp_plane_to_plane if variant == "gicp" else icp.icp_point_to_plane
    want = jfn(jnp.asarray(T0), jnp.asarray(pb), jnp.asarray(vb), jnp.asarray(pa),
               jnp.asarray(va), iterations=iters)
    got = tfn(*(_t(a)[None] for a in (T0, pb, vb, pa, va)), iterations=iters)
    _check(got, want, a_T_b)


def test_icp_batch_equals_single(views):
    """A batch of two problems gives each problem's single result."""
    (pa, va, _), (pb, vb, _), a_T_b = views["corner"]
    T0 = np.stack([a_T_b, np.eye(4)]).astype(np.float32)
    both = icp.icp_plane_to_plane(_t(T0), _t(np.stack([pb, pb])), _t(np.stack([vb, vb])),
                                  _t(np.stack([pa, pa])), _t(np.stack([va, va])), iterations=6)
    for k in range(2):
        one = icp.icp_plane_to_plane(*(_t(a)[None] for a in (T0[k], pb, vb, pa, va)),
                                     iterations=6)
        np.testing.assert_allclose(both.transform[k].numpy(), one.transform[0].numpy(),
                                   atol=1e-6)  # same ops, batched matmul order
        assert int(both.n_pairs[k]) == int(one.n_pairs[0])


def test_percentile_matches_jax():
    rng = np.random.default_rng(3)
    x = np.abs(rng.normal(size=(3, 4800))).astype(np.float32)
    x[:, ::7] = 0.0
    want = np.asarray(jnp.percentile(jnp.asarray(x), 80.0, axis=-1))
    # the same two sorted values and float32 weights; XLA may contract the
    # weighted sum into one FMA: within 1 ulp
    np.testing.assert_allclose(icp._percentile80(_t(x)).numpy(), want, rtol=2.5e-7, atol=0)
