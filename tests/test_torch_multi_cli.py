"""The port's CLI commands vo-multi and slam-multi against the JAX CLI's, on
two tiny TUM directories written by the port's `synthetic --small`: with
--devices cpu:2 both run; their reports have the same keys, slam-multi
writes the same trajectory files (each parsed by the JAX package's reader,
its ATE as the report says within 1e-6 m), and the ATE of both packages is
below 0.02 m. --devices auto without CUDA exits 2 with a message (no
fallback to the CPU)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from rgbdslam_v2_tpu.eval import evaluate_ate as jate  # noqa: E402
from rgbdslam_v2_tpu.io.tum import read_trajectory_file as jread_traj  # noqa: E402
from rgbdslam_v2_tpu_torch.apps import cli  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
FLAGS = ["--camera", "130,130,80,60,160,120"] + [
    x for kv in ("keep_all_nodes=true", "max_keypoints=128", "tpu_max_nodes=32",
                 "tpu_max_edges=512", "tpu_candidate_batch=4", "observability_threshold=0.5",
                 "ransac_iterations=64", "min_matches=12") for x in ("-p", kv)]


@pytest.fixture(scope="module")
def tum_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_cli")
    dirs = []
    for s in (1, 2):
        d = root / f"seq{s}"
        assert cli.main(["synthetic", "--out", str(d), "--frames", "8", "--small", "--seed",
                         str(s), "--device", "cpu"]) == 0
        dirs.append(str(d))
    return dirs


def _json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def _jax_cli(argv) -> str:
    """The JAX CLI in a process of its own (it sizes its CPU platform to
    the --devices count before JAX starts); its standard output."""
    r = subprocess.run([sys.executable, "-m", "rgbdslam_v2_tpu.apps.cli", *argv],
                       cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _keys(d):
    return {k: _keys(v) for k, v in d.items()} if isinstance(d, dict) else None


def test_vo_multi_matches_jax_cli(tum_dirs, capsys):
    capsys.readouterr()
    assert cli.main(["vo-multi", *tum_dirs, "--devices", "cpu:2", *FLAGS]) == 0
    t = _json(capsys.readouterr().out)
    j = _json(_jax_cli(["vo-multi", *tum_dirs, "--devices", "cpu:2", *FLAGS]))
    assert t["devices"] == j["devices"] == 2
    assert _keys(t)["sequences"] == _keys(j)["sequences"]
    assert set(t) == set(j)
    for d in tum_dirs:
        assert t["sequences"][d]["frames"] == j["sequences"][d]["frames"] == 8
        assert t["sequences"][d]["ate_rmse"] < 0.02 and j["sequences"][d]["ate_rmse"] < 0.02


def test_slam_multi_matches_jax_cli(tum_dirs, tmp_path, capsys):
    capsys.readouterr()
    t_out, j_out = tmp_path / "torch", tmp_path / "jax"
    assert cli.main(["slam-multi", *tum_dirs, "--devices", "cpu:2", "--out", str(t_out),
                     *FLAGS]) == 0
    _jax_cli(["slam-multi", *tum_dirs, "--devices", "cpu:2", "--out", str(j_out), *FLAGS])
    t = json.loads((t_out / "slam_multi_report.json").read_text())
    j = json.loads((j_out / "slam_multi_report.json").read_text())
    assert _keys(t) == _keys(j)
    assert t["devices"] == j["devices"] == 2 and t["frames"] == j["frames"] == 8
    assert sorted(p.name for p in t_out.iterdir()) == sorted(p.name for p in j_out.iterdir())
    assert len(list(t_out.glob("seq*_estimate_iteration_*.txt"))) == 10
    for name, entry in t["sequences"].items():
        assert entry["nodes"] == 8
        gt = np.loadtxt(f"{tum_dirs[int(name[3])]}/groundtruth.txt")
        for lv in range(5):
            rows = jread_traj(t_out / f"{name}_estimate_iteration_{lv}.txt")
            assert rows.shape == (8, 8)
            ate = jate(rows[:, 0], rows[:, 1:4], gt[:, 0], gt[:, 1:4]).rmse
            assert abs(ate - entry["ate_rmse"][str(lv)]) < 1e-6
        assert entry["ate_rmse"]["4"] < 0.02 and j["sequences"][name]["ate_rmse"]["4"] < 0.02


@pytest.mark.parametrize("command", ["vo-multi", "slam-multi"])
@pytest.mark.parametrize("devices", ["auto", "default"])
def test_card_devices_without_cuda_exit_2(tum_dirs, tmp_path, capsys, command, devices):
    if torch.cuda.is_available():
        pytest.skip("holds the refusal without CUDA")
    argv = [command, *tum_dirs, "--devices", devices, *FLAGS]
    if command == "slam-multi":
        argv += ["--out", str(tmp_path / "out")]
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "rgbdslam-torch: error:" in err and "CUDA devices, have 0" in err
    assert not (tmp_path / "out").exists()
