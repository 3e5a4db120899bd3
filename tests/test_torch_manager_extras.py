"""GraphManager's remainder in the port against the JAX package, at 160x120:
make_frame, extract and add_node; delete, sanity_check and
memory_footprint, and the checkpoint round trip (the port of
tests/test_manager_extras.py:126-142); a checkpoint the JAX package saved
loads into the port with equal poses, edge pairs and bookkeeping, and the
port's writers then write the JAX package's g2o text, features, clouds
(points within 1e-6 m) and octomap bytes; a run
continued from a checkpoint equals the uninterrupted run; the host wires of
depth_scaling_factor 1.25 equal the JAX package's for u16 counts and for
meters; and the online octomap saves at the JAX package's insert counts.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.core.frames import make_frame as jmake_frame  # noqa: E402
from rgbdslam_v2_tpu.graph import manager as jmanager  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.mapping import VoxelMap as JVoxelMap  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.core.frames import make_frame  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import ingest  # noqa: E402
from rgbdslam_v2_tpu_torch.mapping import VoxelMap  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N = 20
# tests/test_manager_extras.py's _params
BASE = dict(max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
            ransac_iterations=128, min_matches=12, optimizer_skip_step=100,
            keep_all_nodes=True, observability_threshold=0.5)
# 4 frames a step, encode-ahead, pipelined drains, inaffected optimizes
GROUPED = dict(BASE, tpu_frames_per_step=4, tpu_encode_ahead=True, optimizer_skip_step=5,
               pose_relative_to="inaffected", tpu_max_edges=512)


@pytest.fixture(scope="module")
def seq():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N, seed=2, depth_noise_sigma=0.01)
    return np.asarray(poses), np.asarray(rgbs), np.asarray(depths), np.arange(N) / 30.0


def _port(**over):
    return SlamPipeline(Intrinsics(*CAM), ParameterServer({**BASE, **over}), device="cpu")


def test_make_frame_extract_and_add_node_match_jax(seq):
    _, rgbs, depths, _ = seq
    jf = jmake_frame(jnp.asarray(rgbs[1]), jnp.asarray(depths[1]), JIntrinsics(*CAM))
    tf = make_frame(rgbs[1], depths[1], Intrinsics(*CAM))
    for name in ("gray", "rgb", "depth", "valid"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tf.points.numpy(), np.asarray(jf.points), atol=1e-6)
    jpipe = JPipeline(JIntrinsics(*CAM), JParams(dict(BASE)))
    tpipe = _port()
    jkp, tkp = jpipe.manager.extract(jf), tpipe.manager.extract(tf)
    for name in ("uv", "desc", "valid", "xyz", "level"):
        np.testing.assert_array_equal(getattr(tkp, name).numpy(), np.asarray(getattr(jkp, name)),
                                      err_msg=name)
    # add_node is add_frame on the frame's rgb and clipped depth
    a, b = _port(), _port()
    for k in range(3):
        f = make_frame(rgbs[k], depths[k], Intrinsics(*CAM))
        assert a.manager.add_node(f, float(k)) is True
        b.manager.add_frame(rgbs[k], f.depth.numpy(), float(k))
    np.testing.assert_array_equal(a.manager.poses(), b.manager.poses())


def test_delete_sanity_checkpoint(tmp_path, seq):
    """tests/test_manager_extras.py:126-142 on the port."""
    poses, rgbs, depths, stamps = seq
    pipe = _port()
    pipe.run_arrays(rgbs[:6], depths[:6], stamps[:6], gt_poses=poses)
    mgr = pipe.manager
    assert mgr.sanity_check() == []
    n0 = mgr.n_nodes
    mgr.delete_last_frame()
    assert mgr.n_nodes == n0 - 1
    assert mgr.sanity_check() == []
    foot = mgr.memory_footprint()
    assert foot["node_store_bytes"] > 0 and foot["graph_bytes"] > 0 and foot["nodes"] == 5
    path = tmp_path / "state.npz"
    mgr.save_state(path)
    pipe2 = _port()
    pipe2.manager.load_state(path)
    assert pipe2.manager.n_nodes == mgr.n_nodes
    np.testing.assert_allclose(pipe2.manager.poses(), mgr.poses(), atol=1e-6)
    assert pipe2.manager.host.edge_pairs == mgr.host.edge_pairs
    assert pipe2.manager.statistics() == mgr.statistics()
    with np.load(path) as data:  # the JAX package's meta keys; arrays by field name
        import json
        meta = json.loads(str(data["__meta__"]))
        assert {"n_nodes", "n_edges", "n_loop_edges", "n_seq_edges", "timestamps", "keyframes",
                "edge_types", "edge_pairs", "adjacency", "edge_active_host",
                "nodes_opt_watermark", "kp_count0"} <= set(meta)
        assert "store_emm_lohi" in data.files and data["store_emm_lohi"].dtype == np.uint32
    with pytest.raises(ValueError):
        _port(tpu_max_nodes=16).manager.load_state(path)


def test_sanity_check_reports_bad_poses(seq):
    poses, rgbs, depths, stamps = seq
    pipe = _port()
    pipe.run_arrays(rgbs[:3], depths[:3], stamps[:3], gt_poses=poses)
    pipe.manager.graph.poses[2, :3, :3] *= 1.5
    assert any("non-orthonormal" in p for p in pipe.manager.sanity_check())
    pipe.manager.graph.poses[1, 0, 0] = float("nan")
    assert any("non-finite" in p for p in pipe.manager.sanity_check())


def test_jax_checkpoint_loads_into_the_port(tmp_path, seq):
    poses, rgbs, depths, stamps = seq
    jpipe = JPipeline(JIntrinsics(*CAM), JParams(dict(BASE)))
    jpipe.run_arrays(rgbs[:8], depths[:8], stamps[:8], gt_poses=poses)
    jm = jpipe.manager
    jm.save_state(tmp_path / "jax.npz")
    tpipe = _port()
    tm = tpipe.manager
    tm.load_state(tmp_path / "jax.npz")
    np.testing.assert_array_equal(tm.poses(), jm.poses())
    assert tm.host.edge_pairs == jm.edge_pairs
    assert tm.timestamps == jm.timestamps and tm.keyframes == jm.keyframes
    assert tm.n_edges == jm.n_edges and tm.host.edge_types == jm.edge_types
    np.testing.assert_array_equal(tm.host.edge_active, jm.edge_active_host)
    for name in ("uv", "xyz", "desc", "kp_valid", "depth", "color"):
        np.testing.assert_array_equal(getattr(tm.store, name).numpy(),
                                      np.asarray(getattr(jm.store, name)), err_msg=name)
    np.testing.assert_array_equal(tm.store.emm_lohi.numpy().view(np.uint32),
                                  np.asarray(jm.store.emm_lohi))
    # the writers on the carried state write the JAX package's g2o text
    jpipe.save_g2o(tmp_path / "jax.g2o")
    tpipe.save_g2o(tmp_path / "port.g2o")
    assert (tmp_path / "port.g2o").read_text() == (tmp_path / "jax.g2o").read_text()
    jpipe.save_features(tmp_path / "jax.npz.features.npz")
    tpipe.save_features(tmp_path / "port.features.npz")
    with np.load(tmp_path / "jax.npz.features.npz") as a, \
            np.load(tmp_path / "port.features.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a["descriptors"], b["descriptors"])
        np.testing.assert_array_equal(a["node_ids"], b["node_ids"])
        np.testing.assert_allclose(a["positions"], b["positions"], atol=1e-5)
    # clouds: the same points to float32 rounding (XLA fuses the multiply-adds
    # of the transform), colours equal; the octomap's bytes equal
    from rgbdslam_v2_tpu.io.pointcloud import read_pcd
    assert jpipe.save_clouds(tmp_path / "jax.pcd") == tpipe.save_clouds(tmp_path / "port.pcd")
    (jp, jc), (tp, tc) = read_pcd(tmp_path / "jax.pcd"), read_pcd(tmp_path / "port.pcd")
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_array_equal(tc, jc)
    jpipe.save_octomap(tmp_path / "jax.ot")
    tpipe.save_octomap(tmp_path / "port.ot")
    assert (tmp_path / "port.ot").read_bytes() == (tmp_path / "jax.ot").read_bytes()
    # and the port goes on from it
    tpipe.run_arrays(rgbs[8:12], depths[8:12], stamps[8:12])
    assert tm.n_nodes == 12 and tm.sanity_check() == []


@pytest.mark.parametrize("over", [GROUPED, dict(BASE, keep_all_nodes=False,
                                                   backend_solver="pcg", optimizer_skip_step=1)])
def test_continued_run_equals_the_uninterrupted_one(tmp_path, seq, over):
    poses, rgbs, depths, stamps = seq
    a = _port(**over)
    a.run_arrays(rgbs[:11], depths[:11], stamps[:11], gt_poses=poses)
    a.manager.save_state(tmp_path / "mid.npz")
    b = _port(**over)
    b.manager.load_state(tmp_path / "mid.npz")
    for pipe in (a, b):
        pipe.run_arrays(rgbs[11:], depths[11:], stamps[11:])
    np.testing.assert_array_equal(a.manager.poses(), b.manager.poses())
    assert a.manager.statistics() == b.manager.statistics()
    assert a.manager.extractor.fast_threshold == b.manager.extractor.fast_threshold


@pytest.mark.parametrize("fmt", ["yc12", "ydct"])
def test_depth_scaling_factor_encodes_as_jax(seq, fmt):
    _, rgbs, depths, _ = seq
    tm = _port(depth_scaling_factor=1.25, tpu_ingest_format=fmt, tpu_depth_bits=10).manager
    d16 = np.clip(depths[4] * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    for depth in (d16, depths[4]):
        want_depth = jmanager.maybe_scale_depth(depth, 1.25)
        np.testing.assert_array_equal(ingest.maybe_scale_depth(depth, 1.25), want_depth)
        want = jmanager.compact_frame(rgbs[4], want_depth, 2, fmt=fmt, gray_bits=8,
                                      depth_bits=10)
        np.testing.assert_array_equal(tm.encode(rgbs[4], depth), np.asarray(want))
    unscaled = _port(tpu_ingest_format=fmt, tpu_depth_bits=10).manager.encode(rgbs[4], d16)
    assert not np.array_equal(unscaled, tm.encode(rgbs[4], d16))


def test_online_octomap_saves_at_jax_insert_counts(tmp_path, seq, monkeypatch):
    poses, rgbs, depths, stamps = seq
    saves = {"jax": [], "port": []}
    for name, cls in (("jax", JVoxelMap), ("port", VoxelMap)):
        orig = cls.save
        monkeypatch.setattr(cls, "save", lambda self, path, _n=name, _o=orig: (
            saves[_n].append(int((np.asarray(self.state.hits) if _n == "jax"
                                  else self.hits.numpy()).sum())), _o(self, path))[1])
    over = dict(octomap_online_creation=True, octomap_autosave_step=3)
    jpipe = JPipeline(JIntrinsics(*CAM), JParams({**BASE, **over}))
    jpipe.online_octomap_path = str(tmp_path / "jax.ot")
    tpipe = _port(**over, tpu_frames_per_step=4)
    tpipe.online_octomap_path = str(tmp_path / "port.ot")
    for pipe in (jpipe, tpipe):
        pipe.run_arrays(rgbs[:10], depths[:10], stamps[:10], gt_poses=poses)
    assert jpipe._online_inserts == tpipe._online_inserts == 10
    assert len(saves["jax"]) == len(saves["port"]) == 3
    # the hit counts at each save: the same nodes went in by then
    np.testing.assert_allclose(saves["port"], saves["jax"], rtol=0.02)
    assert (tmp_path / "port.ot").stat().st_size > 0


def test_clouds_without_stored_colours_are_black(tmp_path, seq):
    """store_pointclouds=false keeps a 3-byte colour stub a node (JAX
    node_store.py:64,87): the clouds then carry zero colours."""
    poses, rgbs, depths, stamps = seq
    from rgbdslam_v2_tpu_torch.io.pointcloud import read_pcd

    pipe = _port(store_pointclouds=False)
    pipe.run_arrays(rgbs[:3], depths[:3], stamps[:3], gt_poses=poses)
    assert pipe.manager.store.color.shape == (32, 3)
    n = pipe.save_clouds(tmp_path / "c.pcd")
    pts, cols = read_pcd(tmp_path / "c.pcd")
    assert n == len(pts) > 0 and not cols.any()
