"""Batch evaluation: many sequences and parameter sets -> CSV and plots.

Port of ``rgbdslam_v2_tpu/pipeline/batch_eval.py`` (``SequenceResult``,
``evaluate_sequences``, ``write_summary_csv``, ``plot_summary``), the
capability of the reference's evaluation tooling:
  test/run_tests.sh          (run the binary over every sequence with
                              parameter sweeps)
  rgbd_benchmark/summarize_evaluation.sh (per-sequence ATE at optimization
                              levels 0-4, runtime, node and edge counts -> CSV)
  test/figures.py            (plots over the collected ATE results)
as one host-side driver over SlamPipeline. Its sharded variant over a
device mesh waits for ROADMAP Queue 1 item 28.
"""
from __future__ import annotations

import csv
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import ParameterServer
from ..core.camera import Intrinsics
from ..io.tum import TumDataset
from .slam import SlamPipeline


@dataclasses.dataclass
class SequenceResult:
    name: str
    config: str
    ate_by_level: Dict[int, float]
    duration_s: float
    fps: float
    nodes: int
    edges: int


def evaluate_sequences(
    sequences: Sequence,  # (name, tum_dir) pairs
    cam: Intrinsics,
    configs: Optional[Dict[str, dict]] = None,
    out_dir="eval_out",
    max_frames: Optional[int] = None,
    device=None,
) -> List[SequenceResult]:
    """Run the 5-level protocol over every (sequence, config) combination,
    each in a fresh SlamPipeline on ``device`` (the CUDA card unless the
    caller asks for the CPU); writes each run's protocol outputs under
    out_dir/<sequence>__<config>, then summary.csv and summary.json.

    configs: {config_name: parameter overrides}; the default single config
    mirrors the reference's test_settings.launch (keep_all_nodes, offline
    evaluation).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if configs is None:
        configs = {"default": {"keep_all_nodes": True, "observability_threshold": 0.5}}
    results: List[SequenceResult] = []
    for name, tum_dir in sequences:
        ds = TumDataset.open(tum_dir)
        gt_stamps = gt_xyz = None
        if ds.groundtruth is not None:
            gt_stamps = ds.groundtruth[:, 0].tolist()
            gt_xyz = ds.groundtruth[:, 1:4]
        for cfg_name, overrides in configs.items():
            pipe = SlamPipeline(cam, ParameterServer(dict(overrides)), device=device)
            pipe.run_tum(ds, max_frames=max_frames)
            rep = pipe.evaluation_protocol(out / f"{name}__{cfg_name}", gt_stamps=gt_stamps,
                                           gt_xyz=gt_xyz)
            stats = rep.statistics
            results.append(SequenceResult(
                name=name, config=cfg_name,
                ate_by_level={int(k): v for k, v in rep.ate_rmse.items()},
                duration_s=rep.duration_s, fps=rep.fps, nodes=stats["nodes"],
                edges=stats["active_edges"]))
    write_summary_csv(out / "summary.csv", results)
    (out / "summary.json").write_text(json.dumps([dataclasses.asdict(r) for r in results],
                                                 indent=2))
    return results


def write_summary_csv(path, results: List[SequenceResult]) -> None:
    """The summarize_evaluation.sh output shape: one row per run."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sequence", "config"] + [f"ate_L{lvl}" for lvl in range(5)]
                   + ["duration_s", "fps", "nodes", "edges"])
        for r in results:
            w.writerow([r.name, r.config]
                       + [f"{r.ate_by_level.get(lvl, float('nan')):.5f}" for lvl in range(5)]
                       + [f"{r.duration_s:.2f}", f"{r.fps:.2f}", r.nodes, r.edges])


def plot_summary(results: List[SequenceResult], path) -> None:
    """ATE-per-level bars per sequence (the figures.py capability).
    matplotlib is imported here, only when a plot is asked for."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = [f"{r.name}\n{r.config}" for r in results]
    x = np.arange(len(results))
    width = 0.16
    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(results)), 4))
    for li in range(5):
        vals = [r.ate_by_level.get(li, np.nan) for r in results]
        ax.bar(x + (li - 2) * width, vals, width, label=f"L{li}")
    ax.set_xticks(x)
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylabel("ATE RMSE (m)")
    ax.legend(title="opt. level")
    ax.set_title("ATE by optimization/pruning level")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
