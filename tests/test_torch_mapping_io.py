"""The port's map and file writers against the JAX package's, on the same
inputs: the voxel map (ray-walk insert, occupancy filter, occupied voxels)
on the JAX package's full 256x256x128 grid with a rendered frame's cloud
and on a small grid with random clouds; the .ot bytes, against the JAX
writer and the golden fixture (tests/fixtures/golden_3voxel.ot, as
test_golden_formats.py checks it); PCD (binary, ASCII, organized), PLY and
g2o text; voxel_downsample; and the readers on the JAX package's files.

Voxel indices are floor((p - origin) * float32(1 / resolution)) in the
port, the product XLA compiles the JAX division by a constant into; with
it the states are equal (0 voxels differ, asserted).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.core.camera import backproject_grid as jbackproject  # noqa: E402
from rgbdslam_v2_tpu.graph import g2o_io as jg2o  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.io import pointcloud as jpc  # noqa: E402
from rgbdslam_v2_tpu.mapping import VoxelMap as JMap, VoxelMapConfig as JCfg  # noqa: E402
from rgbdslam_v2_tpu.mapping import octree_io as jot  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import g2o_io  # noqa: E402
from rgbdslam_v2_tpu_torch.io import pointcloud  # noqa: E402
from rgbdslam_v2_tpu_torch.mapping import VoxelMap, VoxelMapConfig, octree_io  # noqa: E402

FIXTURES = __import__("pathlib").Path(__file__).parent / "fixtures"
# tests/test_golden_formats.py's voxels, from which the fixture was built
GOLDEN_VOXELS = [((0.025, 0.025, 0.025), 2.0, (200, 30, 30)),
                 ((0.075, 0.025, 0.025), 1.5, (30, 200, 30)),
                 ((-0.025, -0.075, 0.125), 0.9, (30, 30, 200))]
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)


def _maps(**cfg):
    return JMap(JCfg(**cfg)), VoxelMap(VoxelMapConfig(**cfg), device="cpu")


def _assert_same_state(jm, tm):
    for name, got in (("logodds", tm.logodds), ("rgb_sum", tm.rgb_sum), ("hits", tm.hits)):
        want = np.asarray(getattr(jm.state, name))
        differ = int((want != got.numpy()).reshape(len(want), -1).any(-1).sum())
        assert differ == 0, f"{name}: {differ} voxels differ"


@pytest.fixture(scope="module")
def frame_clouds():
    """World clouds of three rendered 160x120 frames (with invalid pixels),
    their colours, validity and camera origins, as the pipeline builds them."""
    world = JWorld.create(seed=1, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, 3, seed=2, depth_noise_sigma=0.01)
    out = []
    for k in range(3):
        d = np.asarray(depths[k]).copy()
        d[::7, ::5] = 0.0
        pts = np.asarray(jse3.apply(jnp.asarray(poses[k]),
                                    jbackproject(jnp.asarray(d), JIntrinsics(*CAM)).reshape(-1, 3)))
        out.append((pts, np.asarray(rgbs[k]).reshape(-1, 3), (d > 0).reshape(-1),
                    np.asarray(poses[k])[:3, 3]))
    return out


def test_voxel_insert_matches_jax_on_the_full_grid(frame_clouds):
    cfg = dict(origin=(-3.2, -3.2, -3.2))
    jm, tm = _maps(**cfg)
    for pts, cols, valid, origin in frame_clouds:
        jm.insert_cloud(pts, cols, valid, origin)
        tm.insert_cloud(pts, cols, valid, origin)
    _assert_same_state(jm, tm)
    assert int((tm.hits > 0).sum()) > 1000
    for (a, b) in zip(jm.occupied_voxels(), tm.occupied_voxels()):
        np.testing.assert_array_equal(a, b)
    pts, _, valid, _ = frame_clouds[0]
    for thr in (0.5, 0.9):
        want = np.asarray(jm.occupancy_filter(pts, valid, thr))
        got = tm.occupancy_filter(pts, valid, thr).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_insert_matches_jax_on_random_clouds(seed):
    """Rays leaving the grid, endpoints outside it, points at the sensor,
    and clamping from repeated inserts."""
    rng = np.random.default_rng(seed)
    cfg = dict(nx=40, ny=48, nz=24, resolution=0.07, origin=(-1.4, -1.7, -0.3),
               max_ray_steps=64, prob_hit=0.8, clamp_max=0.9)
    jm, tm = _maps(**cfg)
    for _ in range(5):
        n = 2000
        origin = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        pts = (origin + rng.normal(0, 1.2, (n, 3))).astype(np.float32)
        pts[:10] = origin  # zero-length rays
        cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        valid = rng.random(n) > 0.1
        jm.insert_cloud(pts, cols, valid, origin)
        tm.insert_cloud(pts, cols, valid, origin)
    _assert_same_state(jm, tm)
    want = np.asarray(jm.occupancy_filter(pts, valid))
    np.testing.assert_array_equal(tm.occupancy_filter(pts, valid).numpy(), want)


def test_octree_bytes_equal_jax_and_golden(tmp_path, frame_clouds):
    jm, tm = _maps(nx=96, ny=96, nz=64, origin=(-2.4, -2.4, -0.8))
    for pts, cols, valid, origin in frame_clouds:
        jm.insert_cloud(pts, cols, valid, origin)
        tm.insert_cloud(pts, cols, valid, origin)
    jm.save(tmp_path / "jax.ot")
    n = tm.save(tmp_path / "port.ot")
    assert n > 100
    assert (tmp_path / "port.ot").read_bytes() == (tmp_path / "jax.ot").read_bytes()
    for a, b in zip(octree_io.read_color_octree(tmp_path / "port.ot"),
                    jot.read_color_octree(tmp_path / "jax.ot")):
        np.testing.assert_array_equal(a, b)
    # the golden fixture: the same bytes from the golden voxels
    centers = np.asarray([v[0] for v in GOLDEN_VOXELS])
    probs = np.asarray([1.0 / (1.0 + np.exp(-v[1])) for v in GOLDEN_VOXELS])
    colors = np.asarray([v[2] for v in GOLDEN_VOXELS], np.uint8)
    octree_io.write_color_octree(tmp_path / "golden.ot", centers, probs, colors, 0.05)
    golden = (FIXTURES / "golden_3voxel.ot").read_bytes()
    mine = (tmp_path / "golden.ot").read_bytes()
    assert mine.partition(b"data\n")[2] == golden.partition(b"data\n")[2]
    fields = [[ln for ln in b.partition(b"data\n")[0].splitlines() if not ln.startswith(b"#")]
              for b in (mine, golden)]
    assert fields[0] == fields[1]


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_ply_text_and_readers_equal_jax(tmp_path, binary):
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 2, (301, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (301, 3)).astype(np.uint8)
    for cols_ in (cols, None):
        pointcloud.write_pcd(tmp_path / "p.pcd", pts, cols_, binary=binary)
        jpc.write_pcd(tmp_path / "j.pcd", pts, cols_, binary=binary)
        assert (tmp_path / "p.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
        pointcloud.write_ply(tmp_path / "p.ply", pts, cols_)
        jpc.write_ply(tmp_path / "j.ply", pts, cols_)
        assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    org = rng.normal(0, 1, (6 * 7, 3)).astype(np.float32)
    pointcloud.write_pcd(tmp_path / "o.pcd", org, cols[:42], organized_hw=(6, 7))
    jpc.write_pcd(tmp_path / "oj.pcd", org, cols[:42], organized_hw=(6, 7))
    assert (tmp_path / "o.pcd").read_bytes() == (tmp_path / "oj.pcd").read_bytes()
    got, want = pointcloud.read_pcd(tmp_path / "oj.pcd", True), jpc.read_pcd(tmp_path / "oj.pcd", True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == (6, 7)


@pytest.mark.parametrize("voxel", [0.05, 0.3, 0.0])
def test_voxel_downsample_equals_jax(voxel):
    rng = np.random.default_rng(6)
    pts = rng.uniform(-2, 2, (5000, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (5000, 3)).astype(np.uint8)
    for a, b in zip(pointcloud.voxel_downsample(pts, cols, voxel),
                    jpc.voxel_downsample(pts, cols, voxel)):
        np.testing.assert_array_equal(a, b)


def test_g2o_text_and_reader_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    xi = jnp.asarray(rng.normal(0, 0.5, (6, 6)).astype(np.float32))
    poses = np.asarray(jse3.exp_se3(xi))
    info = [np.diag(rng.uniform(1, 100, 6)).astype(np.float32) for _ in range(4)]
    edges = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1], info[i]) for i in range(4)]
    g2o_io.write_g2o(tmp_path / "p.g2o", poses, [0, 3], edges)
    jg2o.write_g2o(tmp_path / "j.g2o", poses, [0, 3], edges)
    assert (tmp_path / "p.g2o").read_text() == (tmp_path / "j.g2o").read_text()
    got, want = g2o_io.read_g2o(tmp_path / "j.g2o"), jg2o.read_g2o(tmp_path / "j.g2o")
    assert got[1] == want[1] and got[0].keys() == want[0].keys()
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], atol=1e-6)
    for (i, j, m, inf), (i2, j2, m2, inf2) in zip(got[2], want[2]):
        assert (i, j) == (i2, j2)
        np.testing.assert_allclose(m, m2, atol=1e-6)
        np.testing.assert_array_equal(inf, inf2)


def test_voxel_map_runs_where_asked():
    m = VoxelMap(VoxelMapConfig(nx=8, ny=8, nz=8), device="cpu")
    assert m.logodds.device == torch.device("cpu") and m.logodds.shape == (512,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VoxelMap(VoxelMapConfig(nx=8, ny=8, nz=8))
