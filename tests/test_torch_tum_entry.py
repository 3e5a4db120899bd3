"""The port's TUM entry point against the JAX package, at 160x120 over 25
frames (the verify recipe's scale).

Held here: TumDataset.open and load on a directory the JAX package wrote
(cv2 PNGs) equal the JAX package's, and a directory the port wrote reads
equal in the JAX package (same stamps, index files and ground truth);
TumLoader hands out what sequential loads give, in order, raises a decode
error at its frame and stops on close; run_tum equals run_arrays on the
decoded arrays bitwise (4 frames a step, encode-ahead, skip and step
honoured); the host wires run_tum encodes equal the JAX package's
compact_frame of its own loads bitwise (yc12 and ydct); run_tum against the JAX run_tum(use_native=False): L4 below
0.03 m in both and accepted edges within 25% (ROADMAP F1); and the CLI's
verify recipe on the CPU: L4 below 0.03 m, every output parses with the
JAX package's readers, and the ate subcommand reads the report's L4
(within 1e-6 m: the trajectory file rounds positions to 1e-7 m).
"""
import json
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("cv2")
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import compact_frame as jcompact_frame  # noqa: E402
from rgbdslam_v2_tpu.graph.g2o_io import read_g2o as jread_g2o  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.io.pointcloud import read_pcd as jread_pcd  # noqa: E402
from rgbdslam_v2_tpu.io.synthetic import save_as_tum_dataset as jsave  # noqa: E402
from rgbdslam_v2_tpu.io.tum import TumDataset as JTum  # noqa: E402
from rgbdslam_v2_tpu.io.tum import read_trajectory_file as jread_traj  # noqa: E402
from rgbdslam_v2_tpu.mapping.octree_io import read_color_octree as jread_ot  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.apps import cli  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.io import TumDataset, TumLoader, save_as_tum_dataset, tum  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 25
# the verify recipe's parameters (README.md, the PyTorch/H100 port section)
RECIPE = dict(keep_all_nodes=True, max_keypoints=256, tpu_max_nodes=64, tpu_max_edges=512,
              tpu_candidate_batch=4, observability_threshold=0.5, ransac_iterations=128,
              min_matches=12)
RECIPE_FLAGS = [x for k, v in RECIPE.items() for x in ("-p", f"{k}={str(v).lower()}")]


@pytest.fixture(scope="module")
def sequence():
    world = JWorld.create(seed=3, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=4, depth_noise_sigma=0.01)
    return np.asarray(poses), np.asarray(rgbs), np.asarray(depths)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory, sequence):
    d = tmp_path_factory.mktemp("jax_tum")
    jsave(d, *sequence)
    return d


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory, sequence):
    d = tmp_path_factory.mktemp("port_tum")
    save_as_tum_dataset(d, *sequence)
    return d


def _assert_same_dataset(a, b):
    assert a.pairs == b.pairs and a.timestamps() == b.timestamps() and len(a) == len(b)
    np.testing.assert_array_equal(a.groundtruth, b.groundtruth)
    for i in range(len(a)):
        ta, ra, da = a.load(i)
        tb, rb, db = b.load(i)
        assert ta == tb
        assert ra.dtype == rb.dtype == np.uint8 and da.dtype == db.dtype == np.float32
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da, db)


def test_reads_a_jax_written_directory_as_jax_does(jax_dir):
    _assert_same_dataset(TumDataset.open(jax_dir), JTum.open(jax_dir))


def test_port_written_directory_reads_equal_in_jax(port_dir, jax_dir, sequence):
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        assert (port_dir / name).read_text() == (jax_dir / name).read_text(), name
    _assert_same_dataset(TumDataset.open(port_dir), JTum.open(port_dir))
    _assert_same_dataset(TumDataset.open(port_dir), JTum.open(jax_dir))
    ts, rgb, d16 = TumDataset.open(port_dir).load_raw(3)
    np.testing.assert_array_equal(rgb, sequence[1][3])
    np.testing.assert_array_equal(d16, (sequence[2][3] * 5000.0).astype(np.uint16))


def test_u16_depth_is_written_as_it_is(tmp_path, sequence):
    poses, rgbs, depths = sequence
    d16 = np.clip(depths[:3] * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    save_as_tum_dataset(tmp_path, poses[:3], rgbs[:3], d16)
    ds = TumDataset.open(tmp_path)
    for i in range(3):
        np.testing.assert_array_equal(ds.load_raw(i)[2], d16[i])


@pytest.mark.parametrize("threads,depth,indices", [(2, 8, None), (3, 2, [1, 4, 5, 9, 24]),
                                                   (1, 1, list(range(0, 25, 3)))])
def test_loader_gives_sequential_loads_in_order(port_dir, monkeypatch, threads, depth, indices):
    monkeypatch.setattr(tum, "LOADER_THREADS", threads)
    monkeypatch.setattr(tum, "LOADER_DEPTH", depth)
    ds = TumDataset.open(port_dir)
    want = [ds.load(i) for i in (indices or range(len(ds)))]
    with TumLoader(ds, indices) as loader:
        got = list(loader)
    assert len(got) == len(want)
    assert 0 <= loader.waits <= len(want) and loader.wait_s >= 0.0
    for (ta, ra, da), (tb, rb, db) in zip(got, want):
        assert ta == tb and da.dtype == np.float32
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da, db)


def test_loader_raises_at_a_bad_frame_and_stops_on_close(tmp_path, port_dir, monkeypatch):
    monkeypatch.setattr(tum, "LOADER_THREADS", 2)
    monkeypatch.setattr(tum, "LOADER_DEPTH", 4)
    d = tmp_path / "bad"
    shutil.copytree(port_dir, d)
    ds = TumDataset.open(d)
    bad = d / ds.pairs[6][3]
    bad.write_bytes(bad.read_bytes()[:-30])  # truncated depth PNG
    loader = TumLoader(ds)
    for _ in range(6):
        next(loader)
    with pytest.raises(ValueError):
        next(loader)
    loader.close()
    with pytest.raises(RuntimeError):
        next(loader)
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(RECIPE)), device="cpu")
    with pytest.raises(ValueError):
        pipe.run_tum(ds)
    assert pipe.manager.n_nodes <= 6  # nothing past the bad frame, nothing twice


@pytest.mark.parametrize("over,max_frames", [
    (dict(tpu_frames_per_step=4, tpu_encode_ahead=True, optimizer_skip_step=10,
          pose_relative_to="inaffected"), None),
    (dict(skip_first_n_frames=2, data_skip_step=2, tpu_frames_per_step=2), 9),
])
def test_run_tum_equals_run_arrays(port_dir, over, max_frames):
    ds = TumDataset.open(port_dir)
    a = SlamPipeline(Intrinsics(*CAM), ParameterServer({**RECIPE, **over}), device="cpu")
    waits = a.run_tum(ds, max_frames=max_frames)
    assert set(waits) == {"waits", "wait_s"} and waits["waits"] <= (max_frames or N_FRAMES)
    frames = [ds.load(i) for i in range(len(ds))]
    p = ParameterServer({**RECIPE, **over})
    if max_frames:  # the same frames: run_arrays has no max_frames
        frames = frames[: p["skip_first_n_frames"] + max_frames * p["data_skip_step"]]
    b = SlamPipeline(Intrinsics(*CAM), p, device="cpu")
    b.run_arrays([f[1] for f in frames], [f[2] for f in frames], [f[0] for f in frames])
    assert a.manager.n_nodes == b.manager.n_nodes == (max_frames or N_FRAMES)
    np.testing.assert_array_equal(a.manager.poses(), b.manager.poses())
    assert a.manager.timestamps == b.manager.timestamps
    assert a.manager.statistics() == b.manager.statistics()


@pytest.mark.parametrize("fmt", ["yc12", "ydct"])
def test_run_tum_wire_equals_jax_compact_frame(jax_dir, fmt):
    """The host wires run_tum encodes from a directory cv2 wrote equal,
    bitwise, what the JAX run_tum(use_native=False) encodes from it:
    compact_frame of JAX TumDataset.load's meters."""
    over = dict(tpu_ingest_format=fmt, tpu_depth_bits=10, tpu_encode_ahead=False)
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer({**RECIPE, **over}), device="cpu")
    wires, encode = [], pipe.manager.encode
    pipe.manager.encode = lambda rgb, depth: wires.append(encode(rgb, depth)) or wires[-1]
    pipe.run_tum(TumDataset.open(jax_dir), max_frames=6)
    jm = JPipeline(JIntrinsics(*CAM), JParams({**RECIPE, **over})).manager
    jds = JTum.open(jax_dir)
    assert len(wires) == 6
    for i, wire in enumerate(wires):
        _, rgb, depth = jds.load(i)
        want = jcompact_frame(rgb, depth, jm.emm_stride, fmt=jm.ingest_fmt,
                              gray_bits=jm.gray_bits, depth_bits=jm.depth_bits)
        np.testing.assert_array_equal(wire, np.asarray(want), err_msg=f"frame {i}")


def test_run_tum_against_jax_run_tum(port_dir, tmp_path):
    gt = TumDataset.open(port_dir).groundtruth
    reports = {}
    for name, pipe, ds in (
            ("jax", JPipeline(JIntrinsics(*CAM), JParams(dict(RECIPE))), JTum.open(port_dir)),
            ("port", SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(RECIPE)),
                                  device="cpu"), TumDataset.open(port_dir))):
        if name == "jax":
            pipe.run_tum(ds, use_native=False)
        else:
            pipe.run_tum(ds)
        rep = pipe.evaluation_protocol(tmp_path / name, gt_stamps=gt[:, 0].tolist(),
                                       gt_xyz=gt[:, 1:4])
        st = pipe.manager.statistics()
        reports[name] = (rep.ate_rmse, st["sequential_edges"] + st["loop_edges"], st["nodes"])
    (j_ate, j_acc, j_n), (t_ate, t_acc, t_n) = reports["jax"], reports["port"]
    assert j_n == t_n == N_FRAMES
    assert j_ate[4] < 0.03 and t_ate[4] < 0.03, reports
    assert abs(t_acc - j_acc) <= 0.25 * j_acc, reports


def test_cli_verify_recipe_outputs_parse_in_jax(tmp_path, capsys):
    seq, out = tmp_path / "vseq", tmp_path / "vout"
    assert cli.main(["synthetic", "--out", str(seq), "--frames", str(N_FRAMES), "--small",
                     "--seed", "3", "--device", "cpu"]) == 0
    assert cli.main(["run", "--tum-dir", str(seq), "--out", str(out), "--camera",
                     "130,130,80,60,160,120", "--evaluate", "--save-clouds", "--save-octomap",
                     "--save-g2o", "--save-features", "--device", "cpu", *RECIPE_FLAGS]) == 0
    capsys.readouterr()
    report = json.loads((out / "estimate_report.json").read_text())
    l4, stats = report["ate_rmse"]["4"], report["statistics"]
    assert l4 < 0.03, report["ate_rmse"]
    for level in range(5):
        rows = jread_traj(out / f"estimate_iteration_{level}.txt")
        assert rows.shape == (stats["nodes"], 8) and np.isfinite(rows).all()
    pts, cols = jread_pcd(out / "cloud.pcd")
    assert len(pts) > 0 and cols.shape == pts.shape and np.isfinite(pts).all()
    centers, probs, colors, res = jread_ot(out / "map.ot")
    assert len(centers) > 0 and (probs > 0.5).all() and res == pytest.approx(0.05)
    poses, fixed, edges = jread_g2o(out / "graph.g2o")
    assert len(poses) == stats["nodes"] and len(edges) == stats["active_edges"] and 0 in fixed
    with np.load(out / "features.npz") as f:
        assert f["positions"].shape[0] == f["descriptors"].shape[0] == f["node_ids"].shape[0] > 0
        assert f["positions"].dtype == np.float32 and f["descriptors"].dtype == np.int8
        assert f["node_ids"].dtype == np.int32
    assert cli.main(["ate", str(out / "estimate_iteration_4.txt"),
                     str(seq / "groundtruth.txt")]) == 0
    # the file holds positions to 1e-7 m (%.7f): the ATE read back from it
    # differs from the in-memory one by a few 1e-8 m
    assert json.loads(capsys.readouterr().out)["rmse"] == pytest.approx(l4, abs=1e-6)
    assert cli.main(["rpe", str(out / "estimate_iteration_4.txt"),
                     str(seq / "groundtruth.txt")]) == 0
    rpe = json.loads(capsys.readouterr().out)
    assert rpe["n_pairs"] == N_FRAMES and rpe["translational_m"]["rmse"] < 0.03


def test_cli_run_without_evaluate_writes_estimate(tmp_path, port_dir, capsys):
    out = tmp_path / "out"
    assert cli.main(["run", "--tum-dir", str(port_dir), "--out", str(out), "--camera",
                     "130,130,80,60,160,120", "--max-frames", "8", "--device", "cpu",
                     "--save-individual", *RECIPE_FLAGS]) == 0
    text = capsys.readouterr().out
    stats = json.loads(text[: text.rindex("}") + 1])
    assert stats["nodes"] == 8
    assert jread_traj(out / "estimate.txt").shape == (8, 8)
    clouds = sorted((out / "clouds").glob("node_*.pcd"))
    assert len(clouds) == 8 and all(len(jread_pcd(c)[0]) > 0 for c in clouds)


@pytest.mark.parametrize("argv", [
    ["--pcd-dir", "x"], ["--stereo-dir", "x"], ["--bagfile", "x.bag"], ["--save-mesh"],
    ["--save-bag"], ["--landmark-ba"], ["--serve", "8765"], ["-p", "bagfile_name=x.bag"],
])
def test_cli_unported_options_exit_2(tmp_path, argv, capsys):
    tum = [] if argv[0] in ("--pcd-dir", "--stereo-dir", "--bagfile", "-p") else [
        "--tum-dir", str(tmp_path)]
    assert cli.main(["run", "--out", str(tmp_path / "o"), *tum, *argv]) == 2
    assert "ROADMAP Queue 1 item" in capsys.readouterr().err


def test_cli_synthetic_stereo_and_params(tmp_path, capsys):
    assert cli.main(["synthetic", "--out", str(tmp_path), "--stereo", "0.1"]) == 2
    assert "item 26" in capsys.readouterr().err
    assert cli.main(["params"]) == 0
    assert "depth_scaling_factor" in capsys.readouterr().out
