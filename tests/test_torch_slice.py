"""Port parity for the slice as a whole: the keep-all SLAM main path and the
5-level evaluation protocol, JAX package against the port, on the same
JAX-rendered 160x120 sequence (the verify-recipe scale).

RANSAC draws differ (jax.random vs torch.Generator), so the graphs are not
bitwise equal. Asserted: the first frame's keypoints are identical (their
backprojected xyz too), both
protocol ATE L4 values are below 0.03 m, and the port's accepted-edge count
is within 25% of the JAX package's. The port's torch renderer matches the
JAX renderer (rgb within 1/255, depth within 1e-4 m).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import GraphManager as JManager  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager  # noqa: E402
from rgbdslam_v2_tpu_torch.io import render_sequence  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 25
PARAMS = dict(
    max_keypoints=256, tpu_max_nodes=64, tpu_max_edges=512, tpu_candidate_batch=4,
    ransac_iterations=128, min_matches=12, optimizer_skip_step=10, keep_all_nodes=True,
    observability_threshold=0.5, tpu_drain_pipelined=False,
)


@pytest.fixture(scope="module")
def world():
    return JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))


@pytest.fixture(scope="module")
def sequence(world):
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=2)
    return np.asarray(poses), rgbs, depths, np.arange(N_FRAMES) / 30.0


def _run(pipe, seq, tmp):
    poses, rgbs, depths, stamps = seq
    pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    rep = pipe.evaluation_protocol(tmp, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
    stats = pipe.manager.statistics()
    return rep, stats["sequential_edges"] + stats["loop_edges"]


def test_slice_matches_jax_pipeline(sequence, tmp_path):
    jpipe = JPipeline(JIntrinsics(*CAM), JParams(dict(PARAMS)))
    jrep, j_acc = _run(jpipe, sequence, tmp_path / "jax")
    tpipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(PARAMS)), device="cpu")
    trep, t_acc = _run(tpipe, sequence, tmp_path / "torch")

    js, ts = jpipe.manager.store, tpipe.manager.store
    for name in ("uv", "desc", "kp_valid"):  # first frame: identical keypoints
        np.testing.assert_array_equal(getattr(ts, name)[0].numpy(),
                                      np.asarray(getattr(js, name)[0]), err_msg=name)
    np.testing.assert_array_equal(ts.xyz[0].numpy(), np.asarray(js.xyz[0]), err_msg="xyz")
    assert tpipe.manager.n_nodes == jpipe.manager.n_nodes == N_FRAMES
    assert jrep.ate_rmse[4] < 0.03 and trep.ate_rmse[4] < 0.03, (jrep.ate_rmse, trep.ate_rmse)
    assert abs(t_acc - j_acc) <= 0.25 * j_acc, (t_acc, j_acc)
    assert set(trep.levels) == {0, 1, 2, 3, 4}
    assert trep.fps > 0


@pytest.mark.parametrize("override", [
    # tpu_mesh_devices > 1 runs since the sharded compare was ported
    # (tests/test_torch_parallel.py), and start_paused since the run
    # controls were (tests/test_torch_live_controls.py): an unknown wire
    # format and an unknown descriptor store take their places
    {"tpu_descriptor_dtype": "fp8"}, {"tpu_ingest_format": "jpeg"}, {"tpu_approx_select": True},
])
def test_config_outside_the_slice_raises(override):
    name = next(iter(override))
    with pytest.raises(NotImplementedError, match=name):
        SlamPipeline(Intrinsics(*CAM), ParameterServer({**PARAMS, **override}), device="cpu")


def _recorded(add_frame_group, sizes):
    """add_frame_group that appends each group's length to sizes."""
    def spy(self, compacts, tss, **kw):
        sizes.append(len(compacts))
        return add_frame_group(self, compacts, tss, **kw)
    return spy


def _limit(jax_l4):
    """The ATE bound of an option against the JAX package on the same
    frames (chip_smoke.py phase 14's rule): max(1.5 x, + 5 mm)."""
    return max(1.5 * jax_l4, jax_l4 + 0.005)


@pytest.mark.parametrize("override", [
    {"tpu_gray_bits": 6}, {"tpu_ingest_format": "raw"},
    {"tpu_ingest_format": "raw", "tpu_frames_per_step": 2},
    {"tpu_wire_delta": True, "tpu_wire_delta_max_clamp": 0.6},
    {"tpu_wire_delta": True, "tpu_frames_per_step": 2, "tpu_wire_delta_max_clamp": 0.6},
    {"tpu_edge_info": "hessian"}, {"tpu_emm_exact": True},
    {"g2o_transformation_refinement": 2},
    {"tpu_frames_per_step": 3}, {"tpu_frames_per_step": 12},
])
def test_config_runs_as_in_jax(sequence, tmp_path, override, monkeypatch):
    """Options the port once refused: the configuration runs through both
    packages on the same frames; the port's accepted edges within 25% of
    the JAX package's and its L4 within max(1.5 x, + 5 mm) of it, its frames
    grouped as the JAX package groups them (tpu_frames_per_step clamped to
    [1, 8], a shorter tail group). (A delta clamp budget of 0.6 lets P
    wires through at this size.)"""
    params = {**PARAMS, **override}
    groups = {}
    for name, cls in (("jax", JManager), ("torch", GraphManager)):
        sizes = groups[name] = []
        monkeypatch.setattr(cls, "add_frame_group", _recorded(cls.add_frame_group, sizes))
    jpipe = JPipeline(JIntrinsics(*CAM), JParams(dict(params)))
    jrep, j_acc = _run(jpipe, sequence, tmp_path / "jax")
    tpipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    trep, t_acc = _run(tpipe, sequence, tmp_path / "torch")
    assert tpipe.manager.n_nodes == jpipe.manager.n_nodes == N_FRAMES
    assert groups["torch"] == groups["jax"]
    if "tpu_frames_per_step" in override and not override.get("tpu_wire_delta"):
        n = min(override["tpu_frames_per_step"], 8)
        assert groups["torch"] == [n] * ((N_FRAMES - 1) // n) + [(N_FRAMES - 1) % n] * (
            (N_FRAMES - 1) % n > 1), groups
    assert abs(t_acc - j_acc) <= 0.25 * j_acc, (t_acc, j_acc)
    assert trep.ate_rmse[4] <= _limit(jrep.ate_rmse[4]), (trep.ate_rmse, jrep.ate_rmse)
    m, jm = tpipe.manager, jpipe.manager
    assert (m.ingest_fmt, m.gray_bits, m.depth_bits, m.wire_delta) == (
        jm.ingest_fmt, jm.gray_bits, jm.depth_bits, jm.wire_delta)


@pytest.mark.parametrize("override", [{"tpu_dct_quality": "2.5"}])
def test_ydct_outside_its_domain_raises(override):
    # an unknown quality is a ValueError, as in JAX
    with pytest.raises(ValueError, match="tpu_dct_quality"):
        SlamPipeline(Intrinsics(*CAM), ParameterServer({**PARAMS, "tpu_ingest_format": "ydct",
                                                        **override}), device="cpu")


def test_ydct_outside_its_domain_falls_back(tmp_path):
    """A frame that is not a multiple of 8 cannot carry the ydct wire: both
    packages fall back to yc12 and run; the first frame's keypoints are
    equal, the accepted edges within 25% and L4 within the option bound."""
    cam = (100.0, 100.0, 66.0, 50.0, 132, 100)
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*cam))
    poses, rgbs, depths = jrender(world, 16, seed=2)
    seq = (np.asarray(poses), rgbs, depths, np.arange(16) / 30.0)
    params = {**PARAMS, "tpu_ingest_format": "ydct"}
    jpipe = JPipeline(JIntrinsics(*cam), JParams(dict(params)))
    tpipe = SlamPipeline(Intrinsics(*cam), ParameterServer(dict(params)), device="cpu")
    assert tpipe.manager.ingest_fmt == jpipe.manager.ingest_fmt == "yc12"
    jrep, j_acc = _run(jpipe, seq, tmp_path / "jax")
    trep, t_acc = _run(tpipe, seq, tmp_path / "torch")
    np.testing.assert_array_equal(tpipe.manager.store.uv[0].numpy(),
                                  np.asarray(jpipe.manager.store.uv[0]))
    assert abs(t_acc - j_acc) <= 0.25 * j_acc, (t_acc, j_acc)
    assert trep.ate_rmse[4] <= _limit(jrep.ate_rmse[4]), (trep.ate_rmse, jrep.ate_rmse)


@pytest.mark.parametrize("override", [
    {"keep_all_nodes": False}, {"pose_relative_to": "inaffected"},
    {"min_translation_meter": 0.1, "min_rotation_degree": 5.0}, {"clear_non_keyframes": True},
    {"backend_solver": "pcg"},
    # off the keep-all fast path the JAX package ignores its dispatch options
    {"keep_all_nodes": False, "tpu_drain_pipelined": True, "tpu_frames_per_step": 2,
     "tpu_encode_ahead": True},
    {"tpu_ingest_format": "ydct"}, {"tpu_frames_per_step": 2}, {"tpu_encode_ahead": True},
    {"tpu_drain_pipelined": True},
    # the GICP rescue, on the keep-all fast path and on the host-decision path
    {"use_icp": True}, {"use_icp": True, "keep_all_nodes": False, "icp_variant": "icp"},
    # the TUM entry point's options
    {"depth_scaling_factor": 2.0}, {"octomap_online_creation": True},
    # the feature families and descriptor stores
    {"feature_extractor_type": "SIFT"},
    {"feature_detector_type": "SIFTGPU", "feature_extractor_type": "SIFTGPU",
     "tpu_frames_per_step": 4, "tpu_ingest_format": "ydct"},
    {"feature_extractor_type": "BRISK"}, {"feature_extractor_type": "FREAK"},
    {"tpu_descriptor_dtype": "bf16"}, {"tpu_descriptor_dtype": "float32"},
])
def test_config_inside_the_port_builds(override):
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer({**PARAMS, **override}), device="cpu")
    assert pipe.device.type == "cpu"


def test_torch_renderer_matches_jax(world, sequence):
    poses, rgbs, depths, _ = sequence
    tworld = interop.world_from_numpy(**interop.world_to_numpy(world), cam=Intrinsics(*CAM))
    t_orbit = tworld.orbit_trajectory(N_FRAMES, seed=2, device="cpu").numpy()
    np.testing.assert_allclose(t_orbit, poses, atol=1e-5)
    _, t_rgb, t_depth = render_sequence(tworld, 6, trajectory=poses[:6], device="cpu")
    assert np.abs(t_rgb.astype(int) - rgbs[:6].astype(int)).max() <= 1
    np.testing.assert_allclose(t_depth, depths[:6], atol=1e-4)
    ref = jnp.asarray(depths[:6])
    assert float(jnp.mean(ref > 0)) > 0.99
