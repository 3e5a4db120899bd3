"""The mesh and graph exports in the port (io/meshing.py,
io/visualization.py, SlamPipeline.save_mesh and save_graph_viz) against the
JAX package: grid_mesh_faces, compact_mesh and merge_meshes equal on
random depth grids with holes and jumps; write_ply_mesh's bytes equal and
read_ply_mesh reads them back; draw_feature_flow's image equal. On one JAX
checkpoint (12 frames at 160x120, with odometry edges) loaded into both
packages' pipelines: save_mesh writes the same faces and colours, its
vertices within 1e-5 m, and save_graph_viz the same PLY bytes.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph import odometry as jodometry  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.io import meshing as jmeshing, visualization as jvis  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.io import meshing, visualization  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
BASE = dict(max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
            ransac_iterations=128, min_matches=12, optimizer_skip_step=100,
            keep_all_nodes=True, observability_threshold=0.5, use_robot_odom=True)


def _grid(rng, H=30, W=40):
    depth = (1.0 + rng.random((H, W)) * 0.02 + np.where(rng.random((H, W)) < 0.05, 1.0, 0.0)
             ).astype(np.float32)
    return depth, rng.random((H, W)) > 0.1


@pytest.mark.parametrize("seed", range(3))
def test_mesh_functions_match_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    parts, jparts = [], []
    for jump in (0.05, 0.5):
        depth, valid = _grid(rng)
        faces = meshing.grid_mesh_faces(depth, valid, jump)
        np.testing.assert_array_equal(faces, jmeshing.grid_mesh_faces(depth, valid, jump))
        pts = rng.random((depth.size, 3)).astype(np.float32)
        cols = rng.integers(0, 256, (depth.size, 3)).astype(np.uint8)
        parts.append(meshing.compact_mesh(pts, cols, faces))
        jparts.append(jmeshing.compact_mesh(pts, cols, faces))
    parts.append(meshing.compact_mesh(pts, cols, np.zeros((0, 3), np.int32)))
    jparts.append(jmeshing.compact_mesh(pts, cols, np.zeros((0, 3), np.int32)))
    for a, b in zip(meshing.merge_meshes(parts), jmeshing.merge_meshes(jparts)):
        np.testing.assert_array_equal(a, b)
    verts, vcols, faces = meshing.merge_meshes(parts)
    meshing.write_ply_mesh(tmp_path / "port.ply", verts, vcols, faces)
    jmeshing.write_ply_mesh(tmp_path / "jax.ply", verts, vcols, faces)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for a, b in zip(meshing.read_ply_mesh(tmp_path / "port.ply"), (verts, vcols, faces)):
        np.testing.assert_array_equal(a, b)


def test_draw_feature_flow_matches_jax():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    uv_now, uv_prev = rng.uniform(-5, 85, (30, 2)), rng.uniform(-5, 85, (30, 2))
    valid, inl = rng.random(30) > 0.2, rng.random(30) > 0.5
    for inliers in (None, inl):
        np.testing.assert_array_equal(
            visualization.draw_feature_flow(rgb, uv_now, uv_prev, valid, inliers),
            jvis.draw_feature_flow(rgb, uv_now, uv_prev, valid, inliers))
    # a frame's own keypoints (the live view's pane, drawn as the union of
    # the dots): marks at the borders and rounding to the edge, and marks
    # off the image (the loop)
    own = rng.uniform(-0.45, [80.45, 60.45], (200, 2)).astype(np.float32)
    own[:4] = [[0, 0], [79.6, 59.6], [80.2, 0], [39.5, 30.5]]
    for uv, ok in ((own, rng.random(200) > 0.2), (uv_now, valid)):
        np.testing.assert_array_equal(visualization.draw_feature_flow(rgb, uv, uv, ok),
                                      jvis.draw_feature_flow(rgb, uv, uv, ok))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """A JAX run with odometry edges and the port with its checkpoint."""
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, 12, seed=2)
    stamps = np.arange(12) / 30.0
    jp = JPipeline(JIntrinsics(*CAM), JParams(dict(BASE)))
    jp.manager.set_odometry_provider(jodometry.OdometryProvider(stamps, np.asarray(poses)))
    jp.run_arrays(rgbs, depths, stamps, gt_poses=np.asarray(poses))
    path = tmp_path_factory.mktemp("ckpt") / "state.npz"
    jp.manager.save_state(path)
    tp = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(BASE)), device="cpu")
    tp.manager.load_state(path)
    return jp, tp


@pytest.mark.parametrize("stride,jump", [(1, 0.05), (3, 0.2)])
def test_save_mesh_matches_jax(pipelines, stride, jump, tmp_path):
    jp, tp = pipelines
    n = tp.save_mesh(tmp_path / "port.ply", node_stride=stride, jump_frac=jump)
    assert n == jp.save_mesh(tmp_path / "jax.ply", node_stride=stride, jump_frac=jump) > 1000
    (v, c, f), (jv, jc, jf) = (meshing.read_ply_mesh(tmp_path / f"{k}.ply") for k in ("port", "jax"))
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(v, jv, atol=1e-5)


def test_save_graph_viz_matches_jax(pipelines, tmp_path):
    jp, tp = pipelines
    n = tp.save_graph_viz(tmp_path / "port.ply")
    assert n == jp.save_graph_viz(tmp_path / "jax.ply") > 11
    assert 2 in tp.manager.host.edge_types  # odometry edges, drawn blue
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
