"""The benchmark's files: each parses, BENCHMARK.json keeps to the
contract's shape, and a new configuration, traffic mix or metric is found
by name without an edit to any file that is there."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import tiny  # noqa: F401  (puts slambench/ and the checkout on sys.path)
from lib import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slambench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_file_parses():
    b = spec.benchmark()
    for c in b["configs"]:
        assert spec.load_json(ROOT / c["file"])["params"]
    for kind in ("configs", "traffic", "limits"):
        files = sorted((BENCH / kind).glob("*.json"))
        assert files
        for f in files:
            assert isinstance(spec.load_json(f), dict), f
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert spec.driver(cell["traffic_data"]).Driver
        assert cell["limits"]["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_benchmark_json_shape():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"][:2] == ["python3", "slambench/run.py"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and len(c["source"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [m["name"] for m in spec.cell_metrics(w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.cell_metrics(w["name"], True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark gets a configuration, a traffic mix, a
    metric and a cell as new files and entries; the harness finds them."""
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = spec.benchmark()
    cfg = spec.load_json(BENCH / "configs" / "orb_keepall.json")
    cfg["params"]["max_keypoints"] = 500
    (tmp_path / "slambench/configs/orb_other.json").write_text(json.dumps(cfg))
    tr = spec.load_json(BENCH / "traffic" / "fr1desk_serial.json")
    tr["sequences"] = 2
    (tmp_path / "slambench/traffic/two_serial.json").write_text(json.dumps(tr))
    (tmp_path / "slambench/limits/orb_two.json").write_text(
        (BENCH / "limits" / "sift_fr1desk.json").read_text())
    (tmp_path / "slambench/metrics/nodes_per_s.py").write_text(
        "def read(rec):\n    return 42.0\n")
    b["configs"].append(dict(b["configs"][0], name="orb_other",
                             file="slambench/configs/orb_other.json"))
    b["workloads"].append({"name": "orb_two", "config": "orb_other", "traffic": "two_serial",
                           "chips": 1, "why": "a test cell"})
    b["end_to_end"][0]["workloads"].append("orb_two")
    b["per_layer"].append({"name": "nodes_per_s", "unit": "nodes/s", "better": "higher",
                           "source": "program_counter", "layer": "pipeline and graph manager",
                           "moves": "fps", "workloads": ["orb_two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    probe = (
        "import sys; sys.path.insert(0, 'slambench')\n"
        "from lib import spec\n"
        "c = spec.cell('orb_two')\n"
        "assert c['config_data']['params']['max_keypoints'] == 500\n"
        "assert c['traffic_data']['sequences'] == 2\n"
        "assert spec.driver(c['traffic_data']).__name__ == 'drivers.serial'\n"
        "assert [m['name'] for m in spec.cell_metrics('orb_two', True)] == ['nodes_per_s']\n"
        "assert [m['name'] for m in spec.cell_metrics('orb_two', False)] == ['fps', 'setup_s']\n"
        "assert spec.metric_reader('nodes_per_s')(None) == 42.0\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    # nothing of the original was changed by the copy's additions
    assert spec.benchmark() == json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", ["orb_keepall", "siftgpu_eval"])
def test_config_states_its_rendered_speeds(name):
    import numpy as np
    from lib import render

    cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
    sp = [render.trajectory_speeds(render.World.create(0).orbit(
        cfg["data"]["frames"], s, cfg["render"]["deg_per_frame"], "cpu").numpy(),
        cfg["data"]["fps"]) for s in range(4)]
    m, d = np.mean(sp, axis=0)
    assert abs(m - cfg["speeds"]["rendered_m_per_s"]) < 0.02
    assert abs(d - cfg["speeds"]["rendered_deg_per_s"]) < 0.5
