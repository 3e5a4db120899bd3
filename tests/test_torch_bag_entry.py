"""The port's bag and point-cloud entry points and batch evaluation against
the JAX package, at 160x120 over 16 frames (the verify recipe's scale).

RANSAC draws differ between the packages (ROADMAP F1), so the runs are held
to the slice's rules: the same node count, accepted edges within 25% and L4
within max(1.5 x, + 5 mm) of the JAX package's. Within the port the new
inputs change nothing: run_bag and run_clouds equal run_arrays on the same
frames bitwise (skip_first_n_frames, data_skip_step, max_frames and
depth_scaling_factor honoured, 4 frames a step with encode-ahead). Also
held: save_bagfile read by the JAX reader (one tf a node, the stored depth
and colour), the CLI's --bagfile with ground truth from /tf, -p
bagfile_name, -p topic_points, --pcd-dir and --save-bag (exit 0, outputs
read back), and evaluate_sequences on the CPU writing the JAX package's CSV
header and rows, with plot_summary's PNG.
"""
import csv
import json

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("cv2")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.io import rosbag as jbag  # noqa: E402
from rgbdslam_v2_tpu.io.cloud_input import CloudDataset as JClouds  # noqa: E402
from rgbdslam_v2_tpu.io.tum import read_trajectory_file as jread_traj  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu.pipeline.batch_eval import evaluate_sequences as jevaluate  # noqa: E402
from rgbdslam_v2_tpu_torch.apps import cli  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics, backproject_grid  # noqa: E402
from rgbdslam_v2_tpu_torch.io import rosbag, save_as_tum_dataset  # noqa: E402
from rgbdslam_v2_tpu_torch.io.cloud_input import CloudDataset  # noqa: E402
from rgbdslam_v2_tpu_torch.io.pointcloud import write_pcd  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline.batch_eval import evaluate_sequences, plot_summary  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 16
PARAMS = dict(
    max_keypoints=256, tpu_max_nodes=64, tpu_max_edges=512, tpu_candidate_batch=4,
    ransac_iterations=128, min_matches=12, optimizer_skip_step=10, keep_all_nodes=True,
    observability_threshold=0.5, tpu_drain_pipelined=False,
)
FLAGS = ["--camera", "130,130,80,60,160,120", "--device", "cpu",
         *[x for k, v in PARAMS.items() for x in ("-p", f"{k}={str(v).lower()}")]]


def _limit(jax_l4):
    """max(1.5 x, + 5 mm) of the JAX package's L4 (tests/test_torch_slice.py)."""
    return max(1.5 * jax_l4, jax_l4 + 0.005)


@pytest.fixture(scope="module")
def sequence():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=2, depth_noise_sigma=0.01)
    depths = np.array(depths, np.float32)
    depths[:, 50:60, 70:90] = 0.0  # a hole: invalid depth
    # stamps as the PCD file names give them back
    stamps = np.array([float(f"{1.3e9 + k / 30.0:.6f}") for k in range(N_FRAMES)])
    return np.asarray(poses), np.asarray(rgbs), depths, stamps


@pytest.fixture(scope="module")
def inputs(sequence, tmp_path_factory):
    """The sequence as a bag (ground truth on /tf as /kinect), as organized
    PCDs named by stamp, and as a bag of PointCloud2 messages on /points."""
    poses, rgbs, depths, stamps = sequence
    root = tmp_path_factory.mktemp("inputs")
    bag = rosbag.write_rgbd_bag(root / "seq.bag", stamps, rgbs, depths, gt_poses=poses)
    pcd = root / "pcd"
    pcd.mkdir()
    with rosbag.BagWriter(root / "clouds.bag") as cloud_bag:
        for i in range(N_FRAMES):
            pts = backproject_grid(torch.from_numpy(depths[i]), Intrinsics(*CAM)).numpy()
            pts[depths[i] <= 0] = np.nan
            write_pcd(pcd / f"{stamps[i]:.6f}.pcd", pts.reshape(-1, 3), rgbs[i].reshape(-1, 3),
                      organized_hw=(120, 160))
            cloud_bag.write("/points", "sensor_msgs/PointCloud2", stamps[i],
                            rosbag.PointCloud2Msg.encode(stamps[i], "camera", pts, rgbs[i]))
    return dict(bag=bag, pcd=pcd, cloud_bag=root / "clouds.bag", root=root)


def _accepted(pipe):
    st = pipe.manager.statistics()
    return st["sequential_edges"] + st["loop_edges"]


def _protocol(pipe, out, gt_stamps, gt_xyz):
    return pipe.evaluation_protocol(out, gt_stamps=list(gt_stamps), gt_xyz=gt_xyz)


@pytest.mark.parametrize("source", ["bag", "pcd"])
def test_entry_against_jax(sequence, inputs, tmp_path, source):
    """JAX run_bag / run_clouds against the port's on the same files."""
    poses, _, _, stamps = sequence
    jpipe = JPipeline(JIntrinsics(*CAM), JParams(dict(PARAMS)))
    tpipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(PARAMS)), device="cpu")
    if source == "bag":
        jpipe.run_bag(inputs["bag"])
        tpipe.run_bag(inputs["bag"])
        gt_stamps, gt = rosbag.read_tf_trajectory(inputs["bag"], child_frame="/kinect")
        np.testing.assert_array_equal(gt[:, :3], poses[:, :3, 3])
    else:
        jpipe.run_clouds(JClouds.open(inputs["pcd"], JIntrinsics(*CAM)))
        tpipe.run_clouds(CloudDataset.open(inputs["pcd"], Intrinsics(*CAM)))
        gt_stamps, gt = stamps, poses[:, :3, 3]
    assert tpipe.manager.n_nodes == jpipe.manager.n_nodes == N_FRAMES
    assert tpipe.manager.timestamps == list(jpipe.manager.timestamps)
    jrep = _protocol(jpipe, tmp_path / "jax", gt_stamps, gt[:, :3])
    trep = _protocol(tpipe, tmp_path / "torch", gt_stamps, gt[:, :3])
    j_acc, t_acc = _accepted(jpipe), _accepted(tpipe)
    assert abs(t_acc - j_acc) <= 0.25 * j_acc, (t_acc, j_acc)
    assert trep.ate_rmse[4] <= _limit(jrep.ate_rmse[4]), (trep.ate_rmse, jrep.ate_rmse)
    assert trep.ate_rmse[4] < 0.03


@pytest.mark.parametrize("over,max_frames", [
    (dict(tpu_frames_per_step=4, tpu_encode_ahead=True), None),
    (dict(skip_first_n_frames=2, data_skip_step=2, depth_scaling_factor=1.02,
          tpu_frames_per_step=3), 5),
])
def test_new_inputs_equal_run_arrays(sequence, inputs, over, max_frames):
    """run_bag, run_clouds (a CloudDataset and read_cloud_frames' stream)
    equal run_arrays on the same frames bitwise."""
    _, rgbs, depths, stamps = sequence
    params = {**PARAMS, **over}
    n = N_FRAMES if max_frames is None else 2 + 2 * max_frames - 1
    ref = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    ref.run_arrays(rgbs[:n], depths[:n], stamps[:n])
    runs = {
        "bag": lambda p: p.run_bag(inputs["bag"], max_frames=max_frames),
        "pcd": lambda p: p.run_clouds(CloudDataset.open(inputs["pcd"], Intrinsics(*CAM)),
                                      max_frames=max_frames),
        "stream": lambda p: p.run_clouds(rosbag.read_cloud_frames(inputs["cloud_bag"], "/points"),
                                         max_frames=max_frames),
    }
    for name, run in runs.items():
        pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
        run(pipe)
        assert pipe.manager.n_nodes == ref.manager.n_nodes, name
        np.testing.assert_array_equal(pipe.manager.poses(), ref.manager.poses(), err_msg=name)
        assert pipe.manager.statistics() == ref.manager.statistics(), name
        if name == "bag":
            np.testing.assert_array_equal(pipe.manager.timestamps, ref.manager.timestamps)


def test_save_bagfile_read_by_jax(inputs, tmp_path):
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(PARAMS)), device="cpu")
    pipe.run_bag(inputs["bag"], max_frames=10)
    poses = pipe.manager.poses()
    mgr, cs = pipe.manager, pipe.manager.cam_small
    for include in (False, True):
        path = pipe.save_bagfile(tmp_path / f"r{include}.bag", include_clouds=include)
        ts, rows = jbag.read_tf_trajectory(path, child_frame="/camera")
        assert list(ts) == mgr.timestamps
        np.testing.assert_array_equal(rows[:, :3], poses[:, :3, 3])
        R = np.stack([np.asarray(_quat_to_rot(q)) for q in rows[:, 3:]])
        # the float32 rotations are orthonormal to ~1e-6; the unit quaternion is
        np.testing.assert_allclose(R, poses[:, :3, :3], rtol=0, atol=1e-5)
        frames = list(jbag.read_rgbd_frames(path))
        assert len(frames) == (10 if include else 0)
        for nid, (t, rgb, depth) in enumerate(frames):
            assert t == mgr.timestamps[nid]
            np.testing.assert_array_equal(depth, mgr.store.depth[nid].view(
                cs.height, cs.width).numpy())
            np.testing.assert_array_equal(rgb, mgr.store.color[nid].view(
                cs.height, cs.width, 3).numpy())


def _quat_to_rot(q):
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


@pytest.mark.parametrize("case", ["bagfile_gt", "bagfile_name", "topic_points", "pcd_dir",
                                  "tum_save_bag"])
def test_cli_inputs(sequence, inputs, tmp_path, capsys, case):
    poses, rgbs, depths, stamps = sequence
    out = tmp_path / "out"
    argv = {
        "bagfile_gt": ["--bagfile", inputs["bag"], "-p", "ground_truth_frame_name=/kinect",
                       "--evaluate", "--save-bag"],
        "bagfile_name": ["-p", f"bagfile_name={inputs['bag']}", "--max-frames", "8"],
        "topic_points": ["--bagfile", inputs["cloud_bag"], "-p", "topic_points=/points"],
        "pcd_dir": ["--pcd-dir", inputs["pcd"], "--max-frames", "12"],
        "tum_save_bag": ["--tum-dir", tmp_path / "tum", "--save-bag", "--max-frames", "6"],
    }[case]
    if case == "tum_save_bag":
        save_as_tum_dataset(tmp_path / "tum", poses, rgbs, depths)
    assert cli.main(["run", "--out", str(out), *map(str, argv), *FLAGS]) == 0
    text = capsys.readouterr().out
    n = {"bagfile_name": 8, "pcd_dir": 12, "tum_save_bag": 6}.get(case, N_FRAMES)
    if case == "bagfile_gt":
        report = json.loads((out / "estimate_report.json").read_text())
        assert set(report["ate_rmse"]) == {"0", "1", "2", "3", "4"}
        assert report["ate_rmse"]["4"] < 0.03
        assert report["statistics"]["nodes"] == n
    else:
        rows = jread_traj(out / "estimate.txt")
        assert len(rows) == n and np.isfinite(rows).all()
        if case != "tum_save_bag":  # the TUM directory's stamps are its own
            np.testing.assert_allclose(rows[:, 0], stamps[:n], rtol=0, atol=1e-6)
    if "--save-bag" in argv:
        assert "saved result.bag" in text
        ts, rows = jbag.read_tf_trajectory(out / "result.bag", child_frame="/camera")
        assert len(ts) == n and np.isfinite(rows).all()


def test_cli_needs_an_input(tmp_path, capsys):
    assert cli.main(["run", "--out", str(tmp_path / "o"), "--device", "cpu"]) == 2
    assert "one of --tum-dir, --pcd-dir, --stereo-dir or --bagfile" in capsys.readouterr().err


@pytest.fixture(scope="module")
def two_sequences(tmp_path_factory):
    dirs = []
    for seed in (0, 1):
        world = JWorld.create(seed=seed, texture_size=128, cam=JIntrinsics(*CAM))
        poses, rgbs, depths = jrender(world, 8, seed=seed + 2)
        d = tmp_path_factory.mktemp(f"seq{seed}")
        save_as_tum_dataset(d, np.asarray(poses), np.asarray(rgbs), np.asarray(depths))
        dirs.append((f"seq{seed}", d))
    return dirs


def test_evaluate_sequences_as_jax(two_sequences, tmp_path):
    over = dict(keep_all_nodes=True, max_keypoints=128, tpu_max_nodes=16, tpu_max_edges=128,
                tpu_candidate_batch=2, ransac_iterations=64, min_matches=10,
                observability_threshold=0.5)
    configs = {"a": over, "b": {**over, "nn_distance_ratio": 0.8}}
    jres = jevaluate(two_sequences, JIntrinsics(*CAM), configs=configs, out_dir=tmp_path / "jax")
    tres = evaluate_sequences(two_sequences, Intrinsics(*CAM), configs=configs,
                              out_dir=tmp_path / "torch", device="cpu")
    rows = {k: list(csv.reader(open(tmp_path / k / "summary.csv"))) for k in ("jax", "torch")}
    assert rows["torch"][0] == rows["jax"][0]
    assert [r[:2] for r in rows["torch"]] == [r[:2] for r in rows["jax"]]
    assert len(rows["torch"]) == 5
    summaries = {k: json.loads((tmp_path / k / "summary.json").read_text())
                 for k in ("jax", "torch")}
    assert [sorted(r) for r in summaries["torch"]] == [sorted(r) for r in summaries["jax"]]
    for t, j in zip(tres, jres):
        assert (t.name, t.config, t.nodes) == (j.name, j.config, j.nodes)
        assert sorted(t.ate_by_level) == sorted(j.ate_by_level) == [0, 1, 2, 3, 4]
        assert np.isfinite(t.ate_by_level[4]) and t.ate_by_level[4] < 0.5
    assert (tmp_path / "torch" / "seq1__b" / "estimate_iteration_4.txt").exists()
    plot_summary(tres, tmp_path / "summary.png")
    assert (tmp_path / "summary.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "summary.png").stat().st_size > 1000
