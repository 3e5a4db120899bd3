"""The port's io/render3d.py against the JAX package's (host numpy code in
both): look_at, render_points, overlay_trajectory and render_orbit_views
on seeded numpy inputs give the same numbers and bitwise the same pixels.
The JAX writer encodes through cv2 where it has it and the port through
its own codec (io/png.py), so the files may differ: both are decoded with
the port's reader and their pixels compared."""
import numpy as np
import pytest

pytest.importorskip("jax")
from rgbdslam_v2_tpu.io import render3d as jr  # noqa: E402
from rgbdslam_v2_tpu_torch.io import render3d as tr  # noqa: E402
from rgbdslam_v2_tpu_torch.io.png import read_png  # noqa: E402


def _scene(seed: int, n: int = 4000, frames: int = 12):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * [1.0, 0.5, 1.0] + [0, 0, 3]
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    traj = np.tile(np.eye(4), (frames, 1, 1))
    ang = np.linspace(0, 1.2, frames)
    traj[:, 0, 0], traj[:, 0, 2], traj[:, 2, 0], traj[:, 2, 2] = (
        np.cos(ang), np.sin(ang), -np.sin(ang), np.cos(ang))
    traj[:, :3, 3] = np.stack([np.sin(ang), 0.1 * ang, 1 - np.cos(ang)], -1)
    edges = [(0, 5), (2, 9), (3, 4), (1, 11)]
    return pts.astype(np.float32), cols, traj, edges


@pytest.mark.parametrize("eye,target,up", [
    ((0, -1, -2), (0, 0, 3), (0.0, -1.0, 0.0)),
    ((0, -5, 0), (0, 0, 0), (0.0, -1.0, 0.0)),  # looking along up: the fallback axis
    ((1.5, 0.2, -0.7), (0.3, 0.1, 2.0), (0.2, -1.0, 0.1)),
])
def test_look_at_equals_jax(eye, target, up):
    np.testing.assert_array_equal(tr.look_at(np.array(eye), np.array(target), up),
                                  jr.look_at(np.array(eye), np.array(target), up))


@pytest.mark.parametrize("colored,splat,size", [(True, 2, (160, 120)), (False, 3, (96, 64))])
def test_render_points_and_overlay_equal_jax(colored, splat, size):
    pts, cols, traj, edges = _scene(1)
    cols = cols if colored else None
    T = jr.look_at(np.array([0.5, -1.5, -3.0]), pts.mean(0))
    rgb_t, z_t = tr.render_points(pts, cols, T, size=size, splat=splat)
    rgb_j, z_j = jr.render_points(pts, cols, T, size=size, splat=splat)
    np.testing.assert_array_equal(rgb_t, rgb_j)
    np.testing.assert_array_equal(z_t, z_j)
    assert (rgb_t != 16).any()  # something was drawn
    ov_t = tr.overlay_trajectory(rgb_t.copy(), T, traj, edges, axis_every=3)
    ov_j = jr.overlay_trajectory(rgb_j.copy(), T, traj, edges, axis_every=3)
    np.testing.assert_array_equal(ov_t, ov_j)
    assert (ov_t != rgb_t).any()  # the trajectory and the edges were drawn


def test_render_orbit_views_pixels_equal_jax(tmp_path):
    pts, cols, traj, edges = _scene(2, n=6000)
    kw = dict(traj=traj, edges=edges, n_views=3, size=(128, 96), max_points=5000)
    paths_t = tr.render_orbit_views(pts, cols, tmp_path / "torch", **kw)
    paths_j = jr.render_orbit_views(pts, cols, tmp_path / "jax", **kw)
    assert [p.rsplit("/", 1)[1] for p in paths_t] == [p.rsplit("/", 1)[1] for p in paths_j] == [
        "view_00.png", "view_01.png", "view_02.png"]
    for pt, pj in zip(paths_t, paths_j):
        a, b = read_png(pt), read_png(pj)
        assert a.shape == (96, 128, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
