"""SLAM pipeline: frames -> graph -> trajectories, and the 5-level protocol.

Port of ``rgbdslam_v2_tpu/pipeline/slam.py``: ``SlamPipeline.process_frame``
(without the paused and live-view state), ``run_arrays`` (frames grouped
``tpu_frames_per_step`` a step on the keep-all fast path, host encodes
run ahead on a worker thread with ``tpu_encode_ahead``; without the
octomap and live-view branches) and ``evaluation_protocol``, with
``EvaluationReport``. The per-frame work runs under
``torch.inference_mode``. With no ``device`` the pipeline runs on the CUDA
card, or raises where there is none.
"""
from __future__ import annotations

import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

from ..config import ParameterServer, default_params
from ..core.camera import Intrinsics
from ..eval.ate import evaluate_ate
from ..graph.manager import GraphManager
from ..io.tum import write_trajectory


@dataclasses.dataclass
class EvaluationReport:
    """Per-level trajectory files + ATE (the reference's iteration_0..4)."""

    levels: Dict[int, str]
    ate_rmse: Dict[int, float]
    duration_s: float
    fps: float
    statistics: dict

    def as_dict(self):
        return dataclasses.asdict(self)


class SlamPipeline:
    def __init__(self, cam: Intrinsics, params: Optional[ParameterServer] = None,
                 device=None):
        self.params = params or default_params()
        self.cam = cam
        self.manager = GraphManager(cam, self.params, device=device)
        self.device = self.manager.device
        self.n_processed = 0
        self.n_dropped = 0  # frames that did not enter the graph
        self.wall_time = 0.0

    @torch.inference_mode()
    def process_frame(self, rgb, depth, timestamp: float, gt_pose=None,
                      compact=None) -> bool:
        """One frame (rgb u8 (H, W, 3), depth meters or u16 counts), or a
        pre-packed yc12 buffer. Returns True when the node entered."""
        t0 = time.perf_counter()
        took = self.manager.add_frame(rgb, depth, timestamp, gt_pose, compact=compact)
        self.wall_time += time.perf_counter() - t0
        self.n_processed += 1
        if not took:
            self.n_dropped += 1
        return took

    def run_arrays(self, rgbs, depths, stamps, gt_poses=None) -> None:
        """Feed pre-loaded host arrays (skip_first_n_frames, data_skip_step
        honoured); the first processed frame is anchored at its ground-truth
        pose when given. Where the manager can group them, frames go
        tpu_frames_per_step at a time through one step call. With
        tpu_encode_ahead one worker thread keeps the next two host encodes
        in flight (the same wires, so the same result)."""
        p = self.params
        idxs = list(range(p["skip_first_n_frames"], len(rgbs), max(1, p["data_skip_step"])))
        if not idxs:
            return
        mgr = self.manager
        ngroup = int(p["tpu_frames_per_step"])

        def enc_at(pos):
            return mgr.encode(rgbs[idxs[pos]], depths[idxs[pos]])

        ex = (ThreadPoolExecutor(1, thread_name_prefix="encode-ahead")
              if p["tpu_encode_ahead"] and len(idxs) > 1 else None)
        futs = {}

        def get_enc(pos):
            if ex is None:
                return enc_at(pos)
            f = futs.pop(pos, None)
            out = f.result() if f is not None else enc_at(pos)
            for q in (pos + 1, pos + 2):
                if q < len(idxs) and q not in futs:
                    futs[q] = ex.submit(enc_at, q)
            return out

        try:
            k = 0
            while k < len(idxs):
                cpt = get_enc(k)
                g = min(ngroup, len(idxs) - k)
                if g >= 2 and mgr.can_group(g):
                    cpts = [cpt] + [get_enc(k + m) for m in range(1, g)]
                    self._process_group(cpts, [float(stamps[i]) for i in idxs[k : k + g]])
                    k += g
                    continue
                i = idxs[k]
                gt = gt_poses[idxs[0]] if (gt_poses is not None and mgr.n_nodes == 0) else None
                self.process_frame(None, None, float(stamps[i]), gt, compact=cpt)
                k += 1
        finally:
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)

    @torch.inference_mode()
    def _process_group(self, compacts, stamps) -> None:
        """Frames that all enter the graph (keep-all): one step call."""
        t0 = time.perf_counter()
        self.manager.add_frame_group(compacts, stamps)
        self.wall_time += time.perf_counter() - t0
        self.n_processed += len(compacts)

    @torch.inference_mode()
    def evaluation_protocol(self, out_dir, prefix: str = "estimate", gt_stamps=None,
                            gt_xyz=None) -> EvaluationReport:
        """L0: online estimates; L1: full optimization; L2..L4: prune edges
        with chi2 above edge_error_threshold / 1 / 0.25, re-optimizing after
        each prune (openni_listener.cpp:431)."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        mgr = self.manager
        levels: Dict[int, str] = {}
        ate: Dict[int, float] = {}

        def save_level(level: int):
            stamps, poses = mgr.trajectory()
            path = out / f"{prefix}_iteration_{level}.txt"
            write_trajectory(path, stamps, poses, comment=(
                f"level {level}; frames {self.params['fixed_frame_name']}->"
                f"{self.params['base_frame_name']}"))
            levels[level] = str(path)
            if gt_stamps is not None and gt_xyz is not None and len(stamps) > 2:
                try:
                    ate[level] = evaluate_ate(stamps, poses[:, :3, 3], gt_stamps, gt_xyz).rmse
                except ValueError:
                    pass

        save_level(0)
        saved_fixation = self.params["pose_relative_to"]
        try:
            self.params["pose_relative_to"] = "first"
            mgr.optimize(iterations=self.params["optimizer_iterations"] * 2)
            save_level(1)
            thresholds = ((2, self.params["edge_error_threshold"]), (3, 1.0), (4, 0.25))
            for level, thresh in thresholds:
                mgr.prune_edges_above(thresh)
                mgr.optimize(iterations=self.params["optimizer_iterations"])
                save_level(level)
        finally:
            self.params["pose_relative_to"] = saved_fixation

        fps = self.n_processed / self.wall_time if self.wall_time > 0 else 0.0
        report = EvaluationReport(levels=levels, ate_rmse=ate, duration_s=self.wall_time,
                                  fps=fps, statistics=mgr.statistics())
        (out / f"{prefix}_report.json").write_text(json.dumps(report.as_dict(), indent=2))
        return report
