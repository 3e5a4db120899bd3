"""Each driver runs at 96x72 for a few frames on the CPU through the
program's plain paths and returns a result line of the contract's shape;
the harness exits without a card; the no-JAX check compares top-level
names whole."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import tiny
from lib import env

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["orb_suite8", "sift_fr1desk"]


def _run(cell: str, trace: int, seed: int = 2**31 + 17) -> dict:
    import time

    import run as runmod

    return runmod.run(tiny.Args(cell, seed, 0.5, trace), device="cpu",
                      cell=tiny.tiny_cell(cell, frames=24), t_start=time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_shape(cell, trace):
    out = _run(cell, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and isinstance(out["correct"], bool)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in out["metrics"]
    assert set(out["checks"]) == {"frames_missing", "kp_missing", "desc_gap", "edge_info_gap",
                                  "refit_gap_mm", "pose_excess"}
    assert out["checks"]["frames_missing"]["value"] == 0
    # the port's plain paths extract what the reference extracts
    assert out["checks"]["kp_missing"]["value"] == 0
    json.dumps(out)


def test_same_seed_same_inputs():
    import numpy as np
    from lib import render

    cam = render.Camera(64.7, 64.6, 39.8, 31.9, 80, 60)
    a = [np.empty((3, 60, 80, 3), np.uint8), np.empty((3, 60, 80), np.uint16)]
    b = [np.empty_like(a[0]), np.empty_like(a[1])]
    seed = 2**31 + 5
    pa = render.render_into(*a, 16, 1, render.noise_seed(seed, 0), cam, 0.73, 0.01, "cpu")
    pb = render.render_into(*b, 16, 1, render.noise_seed(seed, 0), cam, 0.73, 0.01, "cpu")
    assert np.array_equal(pa, pb) and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    # another seed: the same worlds in another order, with other noise
    assert sorted(render.run_order(seed, 6)) == sorted(render.run_order(seed + 1, 6))
    assert render.noise_seed(seed, 0) != render.noise_seed(seed + 1, 0)


def test_exits_without_a_card():
    """The command fails and prints no result where torch sees no card."""
    r = subprocess.run([sys.executable, "slambench/run.py", "--workload", "sift_fr1desk",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr


def test_exits_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and slambench/, the
    command fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "slambench/run.py", "--workload", "orb_suite8", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "not in this checkout" in r.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("rgbdslam_v2_tpu_torch", "rgbdslam_v2_tpu_torch.graph", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert env.forbidden_modules() == []
    for name in ("rgbdslam_v2_tpu", "rgbdslam_v2_tpu.graph.manager", "jax.numpy", "jaxlib",
                 "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert env.forbidden_modules() == sorted(["rgbdslam_v2_tpu", "rgbdslam_v2_tpu.graph.manager",
                                              "jax.numpy", "jaxlib", "flax"])


def test_the_harness_loads_no_jax():
    """A whole CPU run of each driver in a fresh process loads neither JAX
    nor the JAX package."""
    probe = (
        "import sys; sys.path[:0] = ['slambench/tests', 'slambench', '.']\n"
        "import tiny, run\n"
        "from lib import env\n"
        "for c in ('orb_suite8', 'sift_fr1desk'):\n"
        "    run.run(tiny.Args(c, 3, 0.3, 0), device='cpu', cell=tiny.tiny_cell(c), t_start=0.0)\n"
        "import control\n"
        "print(env.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """On a card: a short run of each cell prints a result line whose
    device is the card (`python -m pytest --noconftest -m cuda
    slambench/tests/test_slambench_drivers.py` on a machine with one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        r = subprocess.run([sys.executable, "slambench/run.py", "--workload", cell, "--seed", "7",
                            "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                           text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["device"]["platform"] == "gpu"
        assert out["device"]["kind"] == torch.cuda.get_device_name(0)
