"""Batch evaluation: many sequences and parameter sets -> CSV and plots.

Port of ``rgbdslam_v2_tpu/pipeline/batch_eval.py`` (``SequenceResult``,
``evaluate_sequences``, ``evaluate_sequences_sharded``,
``write_summary_csv``, ``plot_summary``), the
capability of the reference's evaluation tooling:
  test/run_tests.sh          (run the binary over every sequence with
                              parameter sweeps)
  rgbd_benchmark/summarize_evaluation.sh (per-sequence ATE at optimization
                              levels 0-4, runtime, node and edge counts -> CSV)
  test/figures.py            (plots over the collected ATE results)
as one host-side loop over SlamPipeline; ``evaluate_sequences_sharded``
runs the visual-odometry frontend of many sequences at once over a device
mesh (parallel/multi_eval.py).
"""
from __future__ import annotations

import csv
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

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


def evaluate_sequences_sharded(
    sequences: Sequence,  # (name, grays (T, H, W), depths (T, H, W), gt_poses) tuples
    cam: Intrinsics,
    params: Optional[ParameterServer] = None,
    out_dir="eval_out_sharded",
    device=None,
) -> List[SequenceResult]:
    """The sequential-VO frontend of every sequence at once, the sequences
    sharded over a tpu_mesh_devices-wide mesh (parallel/multi_eval.py):
    CPU shards where ``device`` is "cpu", else that many CUDA cards. The
    batch is padded to a multiple of the mesh size with copies of the first
    sequence. Writes summary.csv with each sequence's ATE (level 0, against
    its ground truth from the first frame's pose) and its successful
    registrations as edges. The throughput path for frontend sweeps;
    evaluate_sequences runs the full protocol."""
    from ..eval.ate import evaluate_ate
    from ..graph.manager import make_extractor
    from ..parallel import candidate_mesh, vo_trajectories_sharded

    params = params or ParameterServer()
    n_dev = params["tpu_mesh_devices"]
    cpu = device is not None and torch.device(device).type == "cpu"
    mesh = candidate_mesh(n_dev, platform="cpu" if cpu else None)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = [s[0] for s in sequences]
    grays = [np.asarray(s[1], np.float32) for s in sequences]
    depths = [np.asarray(s[2], np.float32) for s in sequences]
    gts = [s[3] for s in sequences]
    pad = (-len(sequences)) % n_dev
    grays += [grays[0]] * pad
    depths += [depths[0]] * pad
    res = vo_trajectories_sharded(
        mesh, grays, depths, params["tpu_seed"],
        make_extractor(params, params["max_keypoints"]), cam,
        max_matches=min(params["max_matches"], params["max_keypoints"]),
        ratio=params["nn_distance_ratio"], n_hypotheses=params["ransac_iterations"],
        min_inliers=params["min_matches"], sigma_depth=params["sigma_depth"])
    poses_all = res.poses.cpu().numpy()
    ok = res.ok.cpu().numpy()
    results: List[SequenceResult] = []
    for i, name in enumerate(names):
        T = poses_all[i]
        stamps = np.arange(T.shape[0]) / 30.0
        ate = float("nan")
        if gts[i] is not None:
            ate = evaluate_ate(stamps, T[:, :3, 3], stamps, np.asarray(gts[i])[:, :3, 3]).rmse
        results.append(SequenceResult(name=name, config="vo_sharded", ate_by_level={0: ate},
                                      duration_s=0.0, fps=0.0, nodes=T.shape[0],
                                      edges=int(ok[i].sum())))
    write_summary_csv(out / "summary.csv", results)
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
