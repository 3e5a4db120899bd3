"""The port's point-cloud input (rgbdslam_v2_tpu_torch/io/cloud_input.py)
against the JAX package's, on the same numpy inputs.

Held here, exactly: read_ply (binary with and without colours, ascii),
load_cloud (organized and flat PCD, PLY), CloudDataset's stamps (float file
stems, else 30 Hz) and loads; cloud_to_rgbd bitwise for organized,
subsampled-organized, incommensurate-organized and unorganized clouds,
with NaN points, points behind the camera and ties in the z-buffer splat;
and an organized cloud of a rendered frame gives back its depth bitwise (z
is the depth) and its colours.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import cloud_input as jci  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics, backproject_grid  # noqa: E402
from rgbdslam_v2_tpu_torch.io import cloud_input as tci  # noqa: E402
from rgbdslam_v2_tpu_torch.io.pointcloud import write_pcd, write_ply  # noqa: E402

CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)


def _eq(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    rng.uniform(0.5, 4.0, n)], -1).astype(np.float32)
    return pts, rng.integers(0, 256, (n, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["binary_rgb", "binary_xyz", "ascii"])
def test_read_ply_as_jax(tmp_path, kind):
    pts, cols = _cloud(50)
    path = tmp_path / "c.ply"
    if kind == "ascii":
        lines = ["ply", "format ascii 1.0", "comment x", "element vertex 50",
                 "property float x", "property float y", "property float z",
                 "property uchar red", "property uchar green", "property uchar blue",
                 "element face 0", "property list uchar int vertex_indices", "end_header"]
        lines += [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}"
                  for p, c in zip(pts, cols)]
        path.write_text("\n".join(lines) + "\n")
    else:
        write_ply(path, pts, cols if kind == "binary_rgb" else None)
    got, want = tci.read_ply(path), jci.read_ply(path)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    np.testing.assert_allclose(got[0], pts, atol=1e-6)


def test_load_cloud_as_jax(tmp_path):
    pts, cols = _cloud(120 * 160, seed=1)
    pts[::7] = np.nan
    write_pcd(tmp_path / "org.pcd", pts, cols, organized_hw=(120, 160))
    write_pcd(tmp_path / "flat.pcd", pts[:300], None)
    write_ply(tmp_path / "c.ply", pts[:40], cols[:40])
    for name in ("org.pcd", "flat.pcd", "c.ply"):
        got, want = tci.load_cloud(tmp_path / name), jci.load_cloud(tmp_path / name)
        for a, b in zip(got[:2], want[:2]):
            _eq(a, b)
        assert got[2] == want[2]
    assert tci.load_cloud(tmp_path / "org.pcd")[2] == (120, 160)
    (tmp_path / "c.xyz").write_text("0 0 1\n")
    with pytest.raises(ValueError, match="unsupported cloud file"):
        tci.load_cloud(tmp_path / "c.xyz")


def test_cloud_dataset_as_jax(tmp_path):
    pts, cols = _cloud(120 * 160, seed=2)
    for name in ("1305031102.175304.pcd", "frame_b.pcd", "1305031102.211214.ply",
                 "notes.txt"):
        if name.endswith(".pcd"):
            write_pcd(tmp_path / name, pts, cols, organized_hw=(120, 160))
        elif name.endswith(".ply"):
            write_ply(tmp_path / name, pts[:500], cols[:500])
        else:
            (tmp_path / name).write_text("not a cloud")
    ds = tci.CloudDataset.open(tmp_path, Intrinsics(*CAM))
    jds = jci.CloudDataset.open(tmp_path, JIntrinsics(*CAM))
    assert [p.name for p in ds.files] == [p.name for p in jds.files]
    assert ds.stamps == jds.stamps and len(ds) == len(jds) == 3
    assert ds.stamps[0] == 1305031102.175304 and ds.stamps[2] == 2 / 30.0
    for i in range(len(ds)):
        got, want = ds.load(i), jds.load(i)
        assert got[0] == want[0]
        _eq(got[1], want[1])
        _eq(got[2], want[2])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tci.CloudDataset.open(tmp_path / "empty", Intrinsics(*CAM))


def _organized(seed, h=120, w=160):
    pts, cols = _cloud(h * w, seed)
    pts[::11] = np.nan  # invalid rows, as PCL writes them
    pts[5::13, 2] = -0.5  # behind the camera
    pts[6::17, 2] = 0.0
    return pts.reshape(h, w, 3), cols.reshape(h, w, 3)


@pytest.mark.parametrize("case", [
    "organized", "organized_flat_hw", "organized_no_colors", "subsampled", "subsampled_x4",
    "incommensurate", "unorganized", "unorganized_no_colors", "unorganized_ties"])
def test_cloud_to_rgbd_as_jax(case):
    cam, jcam = Intrinsics(*CAM), JIntrinsics(*CAM)
    hw = None
    if case.startswith("organized"):
        pts, cols = _organized(3)
        if case == "organized_flat_hw":
            pts, cols, hw = pts.reshape(-1, 3), cols.reshape(-1, 3), (120, 160)
        if case == "organized_no_colors":
            cols = None
    elif case.startswith("subsampled"):
        s = 2 if case == "subsampled" else 4
        pts, cols = _organized(4, 120 // s, 160 // s)
    elif case == "incommensurate":  # organized, but not a divisor of the camera: splatted
        pts, cols = _organized(5, 50, 70)
    else:
        pts, cols = _cloud(30000, seed=6)
        pts[::9] = np.nan
        pts[1::23, 0] = np.inf
        pts[2::31, 2] = -1.0
        if case == "unorganized_ties":
            # many points to one pixel at one depth, others nearer and farther
            # behind them: the stable far-to-near order decides the colour
            tie = np.array([0.4, -0.2, 2.0], np.float32)
            pts[3:400:3] = tie
            pts[600:700:4] = tie * np.float32(1.25)
            pts[800:900:5] = tie * np.float32(0.75)
        if case == "unorganized_no_colors":
            cols = None
    got = tci.cloud_to_rgbd(pts, cols, cam, organized_hw=hw)
    want = jci.cloud_to_rgbd(pts, cols, jcam, organized_hw=hw)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[1].shape == (120, 160) and got[0].shape == (120, 160, 3)


def test_organized_depth_is_the_source_depth(tmp_path):
    """A rendered frame as an organized PCD (invalid depth as NaN rows) comes
    back through CloudDataset with its depth bitwise and its colours."""
    cam = Intrinsics(*CAM)
    world = JWorld.create(seed=0, texture_size=128, cam=JIntrinsics(*CAM))
    _, rgbs, depths = jrender(world, 2, seed=2, depth_noise_sigma=0.01)
    depths = np.array(depths, np.float32)
    depths[:, 10:20, 30:50] = 0.0  # a hole: invalid depth
    for i in range(2):
        depth = depths[i]
        pts = backproject_grid(torch.from_numpy(depth), cam).numpy().reshape(-1, 3)
        pts[depth.reshape(-1) <= 0] = np.nan
        write_pcd(tmp_path / f"{i / 30.0:.6f}.pcd", pts, np.asarray(rgbs[i]).reshape(-1, 3),
                  organized_hw=(120, 160))
    ds = tci.CloudDataset.open(tmp_path, cam)
    for i in range(2):
        ts, rgb, depth = ds.load(i)
        assert ts == float(f"{i / 30.0:.6f}")
        np.testing.assert_array_equal(depth, depths[i])
        np.testing.assert_array_equal(rgb, np.asarray(rgbs[i]))
        assert (depth == 0).any()
