"""The benchmark's pieces, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell names
a configuration (``slambench/configs/<config>.json``) and a traffic mix
(``slambench/traffic/<traffic>.json``, whose ``driver`` key names a module
of ``slambench/drivers/``); its correctness limits are
``slambench/limits/<cell>.json``; each metric is read by
``slambench/metrics/<metric>.py``. A new cell, mix, configuration or
metric is new files and new entries: nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

from .env import ROOT

BENCH = ROOT / "slambench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's BENCHMARK.json entry with its configuration, traffic and
    limits loaded (keys config_spec, config_data, traffic_data, limits)."""
    b = benchmark()
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"slambench: no workload {name!r} in BENCHMARK.json")
    spec = next(c for c in b["configs"] if c["name"] == w["config"])
    return dict(w, config_spec=spec, config_data=load_json(ROOT / spec["file"]),
                traffic_data=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH / "limits" / f"{name}.json"))


def driver(traffic: dict):
    return importlib.import_module(f"drivers.{traffic['driver']}")


def metric_reader(name: str):
    """The read(record) function of slambench/metrics/<name>.py (names may
    hold dots, so the file is loaded by its path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(name: str, trace: bool) -> list:
    """The metrics a run of cell `name` reports: with trace the per-layer
    metrics that list it under their workloads, else its end-to-end
    metrics (one without a workloads key is every cell's)."""
    b = benchmark()
    if trace:
        return [m for m in b["per_layer"] if name in m["workloads"]]
    return [m for m in b["end_to_end"] if name in m.get("workloads", [name])]
