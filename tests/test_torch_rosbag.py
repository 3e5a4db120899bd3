"""The port's ROS bag codec (rgbdslam_v2_tpu_torch/io/rosbag.py) against the
JAX package's, on the same numpy inputs.

Held here: the golden two-message fixture reads the same through both; the
port's write_rgbd_bag without ground truth writes the JAX writer's bytes
(float32 and u16 depth, several chunks), and with ground truth its /tf rows
agree within 1e-7 (the JAX quaternion is float32); each package reads the
other's bag, with bz2 chunks too; every image encoding (rgb8, bgr8, mono8,
16UC1 millimetres, 32FC1 metres, padded rows) decodes the same, and the
port's arrays own their memory; CameraInfo, Odometry and tf decode the
same; approximate-time pairing with unmatched frames and with drop_async,
read_tf_trajectory and read_cloud_frames equal the JAX package's.
"""
import bz2
import struct
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
from rgbdslam_v2_tpu.io import rosbag as jbag  # noqa: E402
from rgbdslam_v2_tpu_torch.io import rosbag as tbag  # noqa: E402

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "golden_2msg.bag"
H, W = 24, 32


def _frames(n=6, seed=0):
    rng = np.random.default_rng(seed)
    stamps = 1e9 + np.arange(n) / 30.0
    rgbs = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    depths = rng.uniform(0.4, 5.0, (n, H, W)).astype(np.float32)
    depths[:, :3, :5] = 0.0  # invalid pixels
    return stamps, rgbs, depths


def _poses(n, seed=1):
    """n random rigid motions (float64), quaternion-built rotations."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-2.0, 2.0, (n, 3))
    return T


def _records(mod, path):
    with mod.BagReader(path) as r:
        return [(t, dt, ts, bytes(raw)) for t, dt, ts, raw in r.records()]


def _assert_frames_equal(a, b):
    assert len(a) == len(b)
    for (ta, ra, da), (tb, rb, db) in zip(a, b):
        assert ta == tb
        for x, y in ((ra, rb), (da, db)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def _as_bz2(src: Path, dst: Path) -> Path:
    """src's bag with every chunk recompressed as bz2 (rosbag's -j mode)."""
    blob = src.read_bytes()
    out, off = [blob[: len(jbag.MAGIC)]], len(jbag.MAGIC)
    while off < len(blob):
        (hlen,) = struct.unpack_from("<I", blob, off)
        hdr = blob[off + 4: off + 4 + hlen]
        (dlen,) = struct.unpack_from("<I", blob, off + 4 + hlen)
        data = blob[off + 8 + hlen: off + 8 + hlen + dlen]
        fields = jbag._decode_header(hdr)
        if fields["op"][0] == jbag.OP_CHUNK:
            fields["compression"] = b"bz2"
            hdr, data = jbag._encode_header(fields), bz2.compress(data)
        out.append(struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data)
        off += 8 + hlen + dlen
    dst.write_bytes(b"".join(out))
    return dst


def test_golden_fixture_reads_the_same():
    assert _records(tbag, FIXTURE) == _records(jbag, FIXTURE)
    for child in ("/camera", None):
        ts, rows = tbag.read_tf_trajectory(FIXTURE, child_frame=child)
        js, jrows = jbag.read_tf_trajectory(FIXTURE, child_frame=child)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(rows, jrows)
    assert len(ts) == 2


@pytest.mark.parametrize("depth", ["float32", "uint16", "chunks"])
def test_writer_bytes_equal_jax(tmp_path, depth):
    """Without ground truth the port writes the JAX writer's bytes; u16
    depth goes in as 32FC1 metres (counts / 5000), never as raw 16UC1."""
    stamps, rgbs, depths = _frames(8)
    if depth == "uint16":
        depths = (depths * 5000).astype(np.uint16)
    for mod, name in ((tbag, "t.bag"), (jbag, "j.bag")):
        if depth == "chunks":  # several chunks, a tf and a cloud among the images
            with mod.BagWriter(tmp_path / name, flush_every=5) as w:
                for i, t in enumerate(stamps):
                    w.write_image("/camera/rgb/image_color", t, rgbs[i])
                    w.write_image("/camera/depth/image", t, depths[i])
                    w.write_tf([mod.TransformStamped(t, "/map", "/camera", np.arange(3.0) * i,
                                                     np.array([0.0, 0.0, 0.0, 1.0]))])
                w.write("/points", "sensor_msgs/PointCloud2", stamps[0],
                        mod.PointCloud2Msg.encode(stamps[0], "cam", depths[0, :4, :, None]
                                                  .repeat(3, -1), rgbs[0, :4]))
        else:
            mod.write_rgbd_bag(tmp_path / name, stamps, rgbs, depths)
    assert (tmp_path / "t.bag").read_bytes() == (tmp_path / "j.bag").read_bytes()
    if depth == "uint16":
        frames = list(tbag.read_rgbd_frames(tmp_path / "t.bag"))
        np.testing.assert_array_equal(frames[2][2], depths[2].astype(np.float32) / 5000.0)


def test_writer_with_ground_truth(tmp_path):
    stamps, rgbs, depths = _frames(6)
    poses = _poses(6)
    tbag.write_rgbd_bag(tmp_path / "t.bag", stamps, rgbs, depths, gt_poses=poses)
    jbag.write_rgbd_bag(tmp_path / "j.bag", stamps, rgbs, depths, gt_poses=poses)
    ts, rows = tbag.read_tf_trajectory(tmp_path / "t.bag", child_frame="/kinect")
    js, jrows = jbag.read_tf_trajectory(tmp_path / "j.bag", child_frame="/kinect")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(rows[:, :3], poses[:, :3, 3])
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=1e-7)
    _assert_frames_equal(list(tbag.read_rgbd_frames(tmp_path / "t.bag")),
                         list(jbag.read_rgbd_frames(tmp_path / "j.bag")))


@pytest.mark.parametrize("writer,compression", [
    ("jax", "none"), ("jax", "bz2"), ("torch", "none"), ("torch", "bz2")])
def test_each_reads_the_others_bag(tmp_path, writer, compression):
    stamps, rgbs, depths = _frames(5, seed=4)
    mod = jbag if writer == "jax" else tbag
    bag = mod.write_rgbd_bag(tmp_path / "a.bag", stamps, rgbs, depths, gt_poses=_poses(5))
    if compression == "bz2":
        bag = _as_bz2(bag, tmp_path / "b.bag")
    got = list(tbag.read_rgbd_frames(bag))
    _assert_frames_equal(got, list(jbag.read_rgbd_frames(bag)))
    assert len(got) == 5
    np.testing.assert_array_equal(got[3][1], rgbs[3])
    np.testing.assert_array_equal(got[3][2], depths[3])
    for mod_r in (tbag, jbag):
        _, rows = mod_r.read_tf_trajectory(bag, child_frame="kinect")
        assert rows.shape == (5, 7)


def _image_raw(encoding, arr, pad=0):
    """A sensor_msgs/Image message of arr with `pad` bytes after each row."""
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).view(np.uint8)
    rows = np.concatenate([rows, np.full((h, pad), 7, np.uint8)], 1)
    data = rows.tobytes()
    return (tbag._ser_header(12.5, "/cam", 3) + struct.pack("<II", h, w)
            + tbag._ser_string(encoding) + b"\x00" + struct.pack("<I", rows.shape[1])
            + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("encoding,pad", [
    ("rgb8", 0), ("rgb8", 4), ("bgr8", 0), ("mono8", 0), ("8UC1", 3), ("16UC1", 0),
    ("mono16", 2), ("32FC1", 0), ("32FC1", 8)])
def test_image_encodings_decode_the_same(encoding, pad):
    rng = np.random.default_rng(len(encoding) + pad)
    arr = {"rgb8": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
           "bgr8": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
           "mono8": rng.integers(0, 256, (H, W), dtype=np.uint8),
           "8UC1": rng.integers(0, 256, (H, W), dtype=np.uint8),
           "16UC1": rng.integers(0, 9000, (H, W), dtype=np.uint16),
           "mono16": rng.integers(0, 9000, (H, W), dtype=np.uint16),
           "32FC1": rng.uniform(0.3, 6.0, (H, W)).astype(np.float32)}[encoding]
    raw = memoryview(_image_raw(encoding, arr, pad))
    t, j = tbag.ImageMsg.decode(raw), jbag.ImageMsg.decode(raw)
    assert (t.stamp, t.frame_id, t.height, t.width, t.encoding, t.step) == (
        j.stamp, j.frame_id, j.height, j.width, j.encoding, j.step)
    got, want = t.as_array(), j.as_array()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.flags.owndata  # a copy: it outlives the bag's mapping
    if encoding in ("16UC1", "mono16"):
        np.testing.assert_array_equal(got, arr.astype(np.float32) * np.float32(1e-3))
    elif encoding == "bgr8":
        np.testing.assert_array_equal(got, arr[..., ::-1])
    else:
        np.testing.assert_array_equal(got, arr)
    with pytest.raises(ValueError, match="unsupported image encoding"):
        tbag.ImageMsg.decode(_image_raw("yuv422", arr)).as_array()


def test_camera_info_odometry_and_tf_decode_the_same():
    K = np.array([525.0, 0.0, 319.5, 0.0, 525.0, 239.5, 0.0, 0.0, 1.0])
    info = (tbag._ser_header(3.25, "/rgb", 9) + struct.pack("<II", 480, 640)
            + tbag._ser_string("plumb_bob") + struct.pack("<I", 5)
            + struct.pack("<5d", 0.1, -0.2, 0.0, 0.0, 0.05) + struct.pack("<9d", *K)
            + struct.pack("<9d", *np.eye(3).ravel()) + struct.pack("<12d", *np.zeros(12)))
    t, j = tbag.CameraInfoMsg.decode(info), jbag.CameraInfoMsg.decode(info)
    assert (t.stamp, t.height, t.width) == (j.stamp, j.height, j.width) == (3.25, 480, 640)
    np.testing.assert_array_equal(t.K, j.K)
    np.testing.assert_array_equal(t.K, K.reshape(3, 3))
    odom = (tbag._ser_header(4.5, "/odom") + tbag._ser_string("/base_link")
            + struct.pack("<3d", 1.0, 2.0, 3.0) + struct.pack("<4d", 0.0, 0.0, 0.6, 0.8))
    t, j = tbag.OdometryMsg.decode(odom), jbag.OdometryMsg.decode(odom)
    assert (t.stamp, t.frame_id, t.child_frame_id) == (j.stamp, j.frame_id, j.child_frame_id)
    np.testing.assert_array_equal(t.position, j.position)
    np.testing.assert_array_equal(t.quaternion, j.quaternion)
    trs = [tbag.TransformStamped(7.0 + k, "/world", f"/c{k}", np.arange(3.0) + k,
                                 np.array([0.0, 0.6, 0.0, 0.8])) for k in range(3)]
    raw = tbag.encode_tf(trs)
    assert raw == jbag.encode_tf([jbag.TransformStamped(*vars(tr).values()) for tr in trs])
    for a, b in zip(tbag.decode_tf(raw), jbag.decode_tf(raw)):
        assert (a.stamp, a.frame_id, a.child_frame_id) == (b.stamp, b.frame_id, b.child_frame_id)
        np.testing.assert_array_equal(a.translation, b.translation)
        np.testing.assert_array_equal(a.quaternion, b.quaternion)


@pytest.mark.parametrize("drop_async", [False, True])
def test_pairing_as_jax(tmp_path, drop_async):
    """RGB frame 2 missing, depth stamps 0-45 ms after their RGB (the pairs
    beyond 1/30 s go with drop_async), an extra depth frame: both packages
    keep the same pairs."""
    _, rgbs, depths = _frames(8, seed=2)
    stamps = 100.0 + 0.1 * np.arange(8)  # neighbours beyond the 0.05 s window
    offsets = [0.0, 0.004, 0.0, 0.041, 0.012, 0.045, 0.0, 0.02]
    with jbag.BagWriter(tmp_path / "gap.bag") as bag:
        for i in range(8):
            if i != 2:
                bag.write_image("camera/rgb/image_color", stamps[i], rgbs[i])
            bag.write_image("/camera/depth/image", stamps[i] + offsets[i], depths[i])
        bag.write_image("/camera/depth/image", stamps[7] + 0.5, depths[0])
    kw = dict(max_difference=0.05, drop_async=drop_async)
    got = list(tbag.read_rgbd_frames(tmp_path / "gap.bag", **kw))
    _assert_frames_equal(got, list(jbag.read_rgbd_frames(tmp_path / "gap.bag", **kw)))
    assert len(got) == (5 if drop_async else 7)
    pairs = tbag.pair_rgbd_messages(tmp_path / "gap.bag", **kw)
    assert [r.stamp for r, _ in pairs] == [t for t, _, _ in got]


def test_read_tf_trajectory_and_cloud_frames_as_jax(tmp_path):
    rng = np.random.default_rng(5)
    grid = rng.normal(0.0, 1.0, (6, 8, 3)).astype(np.float32)
    grid[0, 0] = np.nan
    cols = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    with tbag.BagWriter(tmp_path / "c.bag", flush_every=3) as w:
        for k in range(4):
            t = 20.0 + k / 30.0
            w.write_tf([tbag.TransformStamped(t, "/world", child, np.arange(3.0) * k,
                                              np.array([0.0, 0.0, 0.0, 1.0]))
                        for child in ("/kinect", "/calib")], topic="tf")
            flat = grid.reshape(-1, 3)[: 10 + k]
            msg = (tbag.PointCloud2Msg.encode(t, "cam", grid + k, cols) if k % 2 == 0
                   else tbag.PointCloud2Msg.encode(t, "cam", flat, None if k == 1 else
                                                   cols.reshape(-1, 3)[: 10 + k]))
            w.write("/points", "sensor_msgs/PointCloud2", t, msg)
    for child in ("kinect", "/calib", None):
        ts, rows = tbag.read_tf_trajectory(tmp_path / "c.bag", child_frame=child)
        js, jrows = jbag.read_tf_trajectory(tmp_path / "c.bag", child_frame=child)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(rows, jrows)
    got = list(tbag.read_cloud_frames(tmp_path / "c.bag", "points"))
    want = list(jbag.read_cloud_frames(tmp_path / "c.bag", "/points"))
    assert len(got) == len(want) == 4
    for (ta, pa, ca), (tb, pb, cb) in zip(got, want):
        assert ta == tb
        np.testing.assert_array_equal(pa, pb)
        assert (ca is None) == (cb is None)
        if ca is not None:
            np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(got[0][1], grid)
    np.testing.assert_array_equal(got[2][2], cols)
    assert got[1][2] is None and got[3][1].shape == (13, 3)
