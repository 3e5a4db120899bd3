"""The benchmark's default_fr1desk cell (``slambench/drivers/decided.py``)
at the harness's tiny size on the CPU, through the port's plain paths: a
sound run is correct and reads every per-layer metric it lists that a CPU
run has; a frame the program drops leaves the judge's node-to-frame map
right; a fault that drops every 10th frame, or breaks the optimize or the
registrations, is not correct; the configuration states the speeds it
renders at. orb_fr1desk, the keep-all configuration under the serial mix,
gives a sound result line too.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "slambench" / "tests", ROOT / "slambench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import tiny  # noqa: E402
from lib import spec  # noqa: E402

torch.set_num_threads(1)
CELL = "default_fr1desk"
# read only on the card: device times and the trace's shares, and the
# keep-all step's CUDA-graph replays and bring-up
CARD_ONLY = {"extract_device_ms", "device_idle_pct.single", "refine_roofline_pct.single",
             "replay_host_ms.single", "step_bringup_ms"}


def _run(cell_name=CELL, trace=0, frames=24, seed=2**31 + 17, **traffic):
    import run as runmod

    cell = tiny.tiny_cell(cell_name, frames=frames)
    cell["config_data"]["params"]["tpu_max_nodes"] = max(32, frames)
    cell["traffic_data"].update(traffic)
    return runmod.run(tiny.Args(cell_name, seed, 0.5, trace), device="cpu", cell=cell,
                      t_start=time.perf_counter())


def _drop(monkeypatch, frames):
    """Plant a fault: the frames whose index (stamp x 30 Hz) `frames`
    accepts are dropped before their comparison."""
    from rgbdslam_v2_tpu_torch.graph.manager import GraphManager

    real = GraphManager._add_frame_host

    def dropping(self, packed, timestamp, new_id):
        if frames(round(timestamp * 30)):
            return False
        return real(self, packed, timestamp, new_id)

    monkeypatch.setattr(GraphManager, "_add_frame_host", dropping)


@pytest.mark.parametrize("cell", [CELL, "orb_fr1desk"])
def test_sound_traced_run_reads_its_metrics(cell):
    out = _run(cell, trace=1)
    assert out["correct"], out["checks"]
    listed = {m["name"] for m in spec.cell_metrics(cell, True)}
    assert set(out["metrics"]) == listed - CARD_ONLY, sorted(listed ^ set(out["metrics"]))
    assert all(m["value"] >= 0 for m in out["metrics"].values())
    json.dumps(out)
    if cell == CELL:
        assert 1 <= out["metrics"]["lm_iters_per_opt"]["value"] <= 3


def test_a_dropped_frame_keeps_the_node_to_frame_map(monkeypatch):
    from drivers import decided, serial

    _drop(monkeypatch, lambda k: k == 5)
    every = dict(judge_frames_per_sequence=24)  # every node's keypoints judged
    out = _run(**every)
    assert out["checks"]["frames_missing"]["value"] == 2  # frame 5 of both sequences
    assert out["checks"]["kp_missing"]["value"] == 0.0  # each node against its own frame
    # node n taken for frame n past the drop judges other frames' keypoints
    monkeypatch.setattr(decided.Driver, "_snapshot", serial.Driver._snapshot)
    assert _run(**every)["checks"]["kp_missing"]["value"] > 0.1


def test_dropping_every_10th_frame_is_not_correct(monkeypatch):
    limit = spec.cell(CELL)["limits"]["limits"]["frames_missing"]
    sound = _run(frames=40)
    assert sound["correct"], sound["checks"]
    _drop(monkeypatch, lambda k: k % 10 == 9)
    # enough frames that the two sequences' drops exceed the limit
    out = _run(frames=10 * (int(limit) // 2 + 2))
    assert out["checks"]["frames_missing"]["value"] > limit
    assert not out["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    import faults

    with faults.planted(fault, "decided"):
        out = _run()
    assert not out["correct"], out["checks"]


def test_config_states_its_rendered_speeds():
    from lib import render

    cfg = spec.cell(CELL)["config_data"]
    sp = [render.trajectory_speeds(render.World.create(0).orbit(
        cfg["data"]["frames"], s, cfg["render"]["deg_per_frame"], "cpu").numpy(),
        cfg["data"]["fps"]) for s in range(4)]
    m, d = np.mean(sp, axis=0)
    assert abs(m - cfg["speeds"]["rendered_m_per_s"]) < 0.02
    assert abs(d - cfg["speeds"]["rendered_deg_per_s"]) < 0.5
