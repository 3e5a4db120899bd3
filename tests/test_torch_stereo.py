"""The stereo input in the port (ops/stereo.py, io/stereo_input.py,
SlamPipeline.run_stereo, the CLI's --stereo-dir and synthetic --stereo)
against the JAX package, at 160x120 with tests/test_stereo.py's 0.25 m
baseline.

On JAX-rendered rectified pairs: the valid masks equal the JAX package's
on at least 99.9% of the pixels (all of them on these frames), and the
disparities within 1e-3 px of JAX's on at least 99.9% (the subpixel step
reads box sums added in another order, so its last bits differ); depth within 1e-4 relative where
both are valid. A stereo directory the port writes reads back through
the JAX package's StereoDataset (cv2) as through the port's (libpng's grey
conversion, bitwise), and one the JAX package writes (cv2 PNGs) reads
through the port's. run_stereo on tests/test_stereo.py's 12 frames keeps
its bound (ATE below 0.08 m). Through the CLI, synthetic --stereo writes
a directory that run --stereo-dir reads, with --evaluate, --landmark-ba,
--save-mesh and -p global_loop_candidates=2, and with --serve the live
view and its controls.
"""
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld  # noqa: E402
from rgbdslam_v2_tpu.io import stereo_input as jstereo_input  # noqa: E402
from rgbdslam_v2_tpu.ops import stereo as jstereo  # noqa: E402
from rgbdslam_v2_tpu_torch.apps import cli  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.eval.ate import evaluate_ate  # noqa: E402
from rgbdslam_v2_tpu_torch.io import stereo_input  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import stereo  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
BASELINE = 0.25
N = 12


@pytest.fixture(scope="module")
def jax_pairs():
    """tests/test_stereo.py's render: (poses, left u8, right u8) of 12 orbit
    frames, from the JAX package's render_stereo_sequence."""
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, lefts, rights, _ = jstereo_input.render_stereo_sequence(world, N, BASELINE, seed=2)
    to8 = [np.clip(np.asarray(a) * 255.0, 0, 255).astype(np.uint8) for a in lefts + rights]
    return np.asarray(poses), to8[:N], to8[N:]


@pytest.mark.parametrize("frame", [0, 5, 11])
def test_disparity_and_depth_match_jax(jax_pairs, frame):
    _, lefts, rights = jax_pairs
    gl = stereo_input.png_gray(lefts[frame]).astype(np.float32) / 255.0
    gr = stereo_input.png_gray(rights[frame]).astype(np.float32) / 255.0
    jd, jv = (np.asarray(x) for x in jstereo.disparity_block_matching(jnp.asarray(gl),
                                                                        jnp.asarray(gr)))
    td, tv = (x.numpy() for x in stereo.disparity_block_matching(torch.from_numpy(gl),
                                                                  torch.from_numpy(gr)))
    assert jv.mean() > 0.3
    assert (tv == jv).mean() >= 0.999
    assert (np.abs(td - jd) <= 1e-3).mean() >= 0.999
    jdep, _ = jstereo.stereo_depth(jnp.asarray(gl), jnp.asarray(gr), CAM[0], BASELINE)
    tdep, _ = stereo.stereo_depth(torch.from_numpy(gl), torch.from_numpy(gr), CAM[0], BASELINE)
    jdep, tdep = np.asarray(jdep), tdep.numpy()
    both = (jdep > 0) & (tdep > 0)
    np.testing.assert_allclose(tdep[both], jdep[both], rtol=1e-4)
    assert (tdep[~tv] == 0).all()


def test_box_sum_is_zero_padded_window_sum():
    x = torch.from_numpy(np.random.default_rng(0).random((2, 13, 17)).astype(np.float32))
    pad = np.pad(x.numpy().astype(np.float64), ((0, 0), (4, 4), (4, 4)))
    want = sum(pad[:, dy:dy + 13, dx:dx + 17] for dy in range(9) for dx in range(9))
    np.testing.assert_allclose(stereo.box_sum(x, 9).numpy(), want, rtol=1e-5)


def test_stereo_dataset_round_trip(jax_pairs, tmp_path):
    poses, lefts, rights = jax_pairs
    stereo_input.save_as_stereo_dataset(tmp_path / "port", poses[:3], lefts[:3], rights[:3])
    jstereo_input.save_as_stereo_dataset(tmp_path / "jax", poses[:3], lefts[:3], rights[:3])
    for root in ("port", "jax"):
        ds = stereo_input.StereoDataset.open(tmp_path / root)
        jds = jstereo_input.StereoDataset.open(tmp_path / root)
        assert len(ds) == len(jds) == 3
        for i in range(3):
            got, want = ds.load(i), jds.load(i)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], lefts[i])
            for a, b in zip(got[1:], want[1:]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    gt = np.loadtxt(tmp_path / "port" / "groundtruth.txt")
    np.testing.assert_array_equal(gt, np.loadtxt(tmp_path / "jax" / "groundtruth.txt"))


def test_run_stereo_keeps_the_jax_bound(jax_pairs, tmp_path):
    """tests/test_stereo.py's SLAM run on the port: 12 frames, at least 10
    nodes, ATE below 0.08 m after a blocking optimize."""
    poses, lefts, rights = jax_pairs
    stereo_input.save_as_stereo_dataset(tmp_path, poses, lefts, rights)
    params = ParameterServer(dict(
        max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
        ransac_iterations=128, min_matches=12, keep_all_nodes=True, observability_threshold=0.5,
        stereo_baseline=BASELINE, stereo_max_disparity=64))
    pipe = SlamPipeline(Intrinsics(*CAM), params, device="cpu")
    pipe.run_stereo(stereo_input.StereoDataset.open(tmp_path))
    assert pipe.manager.n_nodes >= 10
    pipe.manager.optimize(blocking=True)
    stamps, est = pipe.manager.trajectory()
    res = evaluate_ate(stamps, est[:, :3, 3], [k / 30.0 for k in range(N)], poses[:, :3, 3])
    assert res.rmse < 0.08, res.rmse


CLI_PARAMS = ["-p", "keep_all_nodes=true", "-p", "max_keypoints=256", "-p", "tpu_max_nodes=64",
              "-p", "tpu_max_edges=512", "-p", "tpu_candidate_batch=4", "-p",
              "observability_threshold=0.5", "-p", "ransac_iterations=128", "-p", "min_matches=12"]


def test_cli_stereo_landmark_ba_mesh_retrieval(tmp_path, capsys):
    """The options that exited 2 before: synthetic --stereo, then run
    --stereo-dir with --evaluate, --landmark-ba, --save-mesh and -p
    global_loop_candidates=2 (frames 10 onward retrieve)."""
    seq = tmp_path / "seq"
    assert cli.main(["synthetic", "--out", str(seq), "--frames", "16", "--small", "--seed", "3",
                     "--device", "cpu", "--stereo", str(BASELINE)]) == 0
    assert (seq / "left").is_dir() and (seq / "right").is_dir() and (seq / "rgb").is_dir()
    out = tmp_path / "out"
    code = cli.main(["run", "--stereo-dir", str(seq), "--out", str(out), "--camera",
                     ",".join(map(str, CAM)), "--evaluate", "--landmark-ba", "--save-mesh",
                     "--device", "cpu", "-p", f"stereo_baseline={BASELINE}", "-p",
                     "global_loop_candidates=2", *CLI_PARAMS])
    text = capsys.readouterr().out
    assert code == 0
    report = json.loads((out / "estimate_report.json").read_text())
    assert report["statistics"]["nodes"] == 16
    assert set(report["ate_rmse"]) == {"0", "1", "2", "3", "4"}  # the shared ground truth
    assert "landmark BA: " in text and (out / "estimate_landmark_ba.txt").is_file()
    assert "saved mesh.ply" in text and (out / "mesh.ply").stat().st_size > 1000


def test_cli_stereo_dir_serves_live_view(jax_pairs, tmp_path, capsys, monkeypatch):
    """run --stereo-dir with --serve 0 (ROADMAP item 27b, which exited 2
    before): the live outputs refresh every 2 frames beside the run's, the
    depth pane from the stereo depth; during the final linger the server
    it started answers the page with the run controls, the panes and
    /ctl/pause."""
    import urllib.request

    poses, lefts, rights = jax_pairs
    stereo_input.save_as_stereo_dataset(tmp_path / "seq", poses[:6], lefts[:6], rights[:6])
    served = {}

    def linger(seconds):  # the CLI's wait for the page's last poll
        url = json.loads(capsys.readouterr().err.strip().splitlines()[-1])["url"]
        served["page"] = urllib.request.urlopen(url, timeout=10).read()
        served["depth"] = urllib.request.urlopen(url + "depth.png", timeout=10).read()
        req = urllib.request.Request(url + "ctl/pause", method="POST")
        served["pause"] = json.loads(urllib.request.urlopen(req, timeout=10).read())

    monkeypatch.setattr(cli.time, "sleep", linger)
    out = tmp_path / "out"
    assert cli.main(["run", "--stereo-dir", str(tmp_path / "seq"), "--out", str(out), "--camera",
                     ",".join(map(str, CAM)), "--serve", "0", "--serve-interval", "2",
                     "--device", "cpu", "-p", f"stereo_baseline={BASELINE}", *CLI_PARAMS]) == 0
    for name in ("estimate.txt", "graph.g2o", "frame.png", "depth.png"):
        assert (out / name).is_file(), name
    assert len(np.loadtxt(out / "estimate.txt")) == 6
    assert b"bPause" in served["page"] and b"const DATA" in served["page"]
    assert served["depth"][:8] == b"\x89PNG\r\n\x1a\n"
    assert served["pause"] == {"status": "paused"}
