"""Port parity for the default configuration's path as a whole: the
host-decision path (keep_all_nodes=False), PCG online optimize of every
node and the 5-level protocol, JAX package against the port, on the same
JAX-rendered 25-frame 160x120 sequence (the verify-recipe scale).

RANSAC draws differ (jax.random vs torch.Generator, ROADMAP F1), so the
graphs are not bitwise equal. Asserted: the first frame's keypoints and
xyz are identical; node counts are within 2 (a frame whose predecessor
match is borderline may be kept in one package and dropped in the other);
accepted edges are within 25%; protocol ATE L4 is below 0.03 m in both;
every optimize used PCG. Also: default_params() at 640x480 passes the
port's configuration check and builds on the CPU when asked to, and a
GraphManager given no device runs on the CUDA card or raises.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer, default_params  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT, Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager, check_slice  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 25
PARAMS = dict(
    max_keypoints=256, tpu_max_nodes=64, tpu_max_edges=512, tpu_candidate_batch=4,
    ransac_iterations=128, min_matches=12, keep_all_nodes=False, backend_solver="pcg",
    optimizer_skip_step=1,
)


@pytest.fixture(scope="module")
def sequence():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=2)
    return np.asarray(poses), rgbs, depths, np.arange(N_FRAMES) / 30.0


def _run(pipe, seq, tmp):
    poses, rgbs, depths, stamps = seq
    pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    rep = pipe.evaluation_protocol(tmp, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
    stats = pipe.manager.statistics()
    return rep, stats["sequential_edges"] + stats["loop_edges"]


def test_default_path_matches_jax_pipeline(sequence, tmp_path):
    jpipe = JPipeline(JIntrinsics(*CAM), JParams(dict(PARAMS)))
    jrep, j_acc = _run(jpipe, sequence, tmp_path / "jax")
    tpipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(PARAMS)), device="cpu")
    trep, t_acc = _run(tpipe, sequence, tmp_path / "torch")

    js, ts = jpipe.manager.store, tpipe.manager.store
    for name in ("uv", "desc", "kp_valid", "xyz"):  # first frame: identical keypoints
        np.testing.assert_array_equal(getattr(ts, name)[0].numpy(),
                                      np.asarray(getattr(js, name)[0]), err_msg=name)
    jn, tn = jpipe.manager.n_nodes, tpipe.manager.n_nodes
    assert abs(tn - jn) <= 2, (tn, jn)
    assert tpipe.n_processed == N_FRAMES and tn + tpipe.n_dropped == N_FRAMES
    assert jrep.ate_rmse[4] < 0.03 and trep.ate_rmse[4] < 0.03, (jrep.ate_rmse, trep.ate_rmse)
    assert abs(t_acc - j_acc) <= 0.25 * j_acc, (t_acc, j_acc)
    assert set(trep.levels) == {0, 1, 2, 3, 4}
    calls = tpipe.manager.solver_calls
    assert calls["dense"] == 0 and calls["pcg"] >= tn - 1, calls
    assert len(tpipe.manager.keyframes) >= 2


def test_default_params_build_on_the_cpu_when_asked():
    p = default_params()
    assert not p["keep_all_nodes"] and p["tpu_drain_pipelined"] and p["tpu_max_nodes"] == 4096
    check_slice(p, TUM_DEFAULT)
    pipe = SlamPipeline(TUM_DEFAULT, p, device="cpu")
    mgr = pipe.manager
    assert mgr.device.type == "cpu" and mgr.graph.poses.shape == (4096, 4, 4)
    assert mgr._solver(mgr.n_cap) == "pcg"


def test_no_device_means_the_card():
    cam = Intrinsics(*CAM)
    params = ParameterServer(dict(PARAMS))
    if torch.cuda.is_available():
        assert GraphManager(cam, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GraphManager(cam, params)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SlamPipeline(cam, params)
