"""The comparison that decides `correct` fails where it has to.

At 160x120 (the cells' camera scaled by 1/4) on the CPU, through the
program's plain paths:

* the control (the plain reference in bfloat16 in the program's place,
  ``control.readings``) comes out not correct through the cell's limits,
  and reads above them in the numbers named below, while the program's
  sound run reads within them;
* a run with the timed path broken underneath comes out not correct, once
  for each fault the cell can have (``faults.py``): a step that returns
  its state unchanged, half of the batch left out, an answer altered
  where it is produced. The cells run on one chip, so there is no
  exchange between chips to leave out.
"""
from __future__ import annotations

import time

import pytest

import tiny  # noqa: I001  (puts slambench/ and the checkout on sys.path)
import faults  # noqa: E402

CELLS = ["orb_suite8", "sift_fr1desk"]


def small_cell(name: str) -> dict:
    cell = tiny.tiny_cell(name, frames=20)
    cam = cell["config_data"]["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= 0.25 / 0.15
    cam["width"], cam["height"] = 160, 120
    cell["config_data"]["params"].update(max_keypoints=300, tpu_candidate_batch=8)
    return cell


def run_cell(name: str, seed: int = 11) -> dict:
    import run as runmod

    return runmod.run(tiny.Args(name, seed, 0.1, 0), device="cpu", cell=small_cell(name),
                      t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_fails(name):
    import control

    out = run_cell(name)
    assert out["correct"], out["checks"]
    limits = small_cell(name)["limits"]["limits"]
    r = control.readings(small_cell(name), 11, device="cpu")
    assert r["correct"] and not r["control.correct"], r
    for k in ("kp_missing", "edge_info_gap", "refit_gap_mm", "pose_excess"):
        assert r[k] <= limits[k] < r["control." + k], (k, r)


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    driver = small_cell(name)["traffic_data"]["driver"]
    with faults.planted(fault, driver):
        out = run_cell(name)
    assert not out["correct"], out["checks"]
