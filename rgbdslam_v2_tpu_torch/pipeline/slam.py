"""SLAM pipeline: frames -> graph -> trajectories, maps and the 5-level protocol.

Port of ``rgbdslam_v2_tpu/pipeline/slam.py``: ``SlamPipeline.process_frame``
(without the paused and live-view state), ``run_arrays`` and ``run_tum``
(frames grouped ``tpu_frames_per_step`` a step on the keep-all fast path,
host encodes run ahead on a worker thread with ``tpu_encode_ahead``; both
share one loop over a frame source, ``_run_frames``), the online octomap
(``octomap_online_creation``, ``octomap_autosave_step``), the writers
``save_clouds``, ``save_individual_clouds``, ``save_octomap``,
``save_g2o`` and ``save_features`` over ``_node_world_cloud``, and
``evaluation_protocol`` with ``EvaluationReport``. The per-frame work runs
under ``torch.inference_mode``. With no ``device`` the pipeline runs on the
CUDA card, or raises where there is none.

``run_tum`` decodes the PNGs on ``io/tum.TumLoader``'s threads and feeds
the host encoder what the JAX ``run_tum`` feeds its own: ``TumDataset.load``'s
``d16 / 5000`` float32 meters, which the encoder truncates back to counts
(one count low on 7% of the u16 values, ROADMAP F14, a fault of both
packages). Grouping changes no result: 4 frames a step, replayed, give the
trajectory of 1 eager frame a step (``chip_smoke.py`` phase 7), where the
JAX ``run_tum`` feeds one frame a ``process_frame`` call.
"""
from __future__ import annotations

import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ParameterServer, default_params
from ..core import se3
from ..core.camera import Intrinsics, backproject_grid
from ..eval.ate import evaluate_ate
from ..graph.manager import GraphManager
from ..interop import tensor_to_numpy
from ..io.tum import TumDataset, TumLoader, write_trajectory
from ..mapping import VoxelMap, VoxelMapConfig


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
        # online octomap creation (graph_manager.cpp:1044-1049)
        self._online_map: Optional[VoxelMap] = None
        self._online_inserts = 0
        self.online_octomap_path = "map_online.ot"

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
        elif self.params["octomap_online_creation"]:
            self._online_octomap_insert(self.manager.n_nodes - 1)
        return took

    def map_config(self) -> VoxelMapConfig:
        """The voxel map's settings from the octomap_* parameters."""
        p = self.params
        return VoxelMapConfig(
            resolution=p["octomap_resolution"], prob_hit=p["octomap_prob_hit"],
            prob_miss=p["octomap_prob_miss"], clamp_min=p["octomap_clamping_min"],
            clamp_max=p["octomap_clamping_max"],
            occupancy_threshold=p["octomap_occupancy_threshold"])

    def _online_octomap_insert(self, node_id: int) -> None:
        """octomap_online_creation: insert each accepted node's cloud as it
        arrives; save every octomap_autosave_step inserts
        (graph_mgr_io.cpp:292-295, ColorOctomapServer.cpp:84-87)."""
        if self._online_map is None:
            self._online_map = VoxelMap(self.map_config(), device=self.device)
        self._online_map.insert_cloud(*self._node_world_cloud(node_id))
        self._online_inserts += 1
        step = self.params["octomap_autosave_step"]
        if step > 0 and self._online_inserts % step == 0:
            self._online_map.save(self.online_octomap_path)

    def run_arrays(self, rgbs, depths, stamps, gt_poses=None) -> None:
        """Feed pre-loaded host arrays (skip_first_n_frames, data_skip_step
        honoured); the first processed frame is anchored at its ground-truth
        pose when given."""
        p = self.params
        idxs = list(range(p["skip_first_n_frames"], len(rgbs), max(1, p["data_skip_step"])))
        if not idxs:
            return
        mgr = self.manager
        self._run_frames([float(stamps[i]) for i in idxs],
                         lambda pos: mgr.encode(rgbs[idxs[pos]], depths[idxs[pos]]),
                         None if gt_poses is None else gt_poses[idxs[0]])

    def run_tum(self, dataset: TumDataset, max_frames: Optional[int] = None) -> dict:
        """Process a TUM dataset (skip_first_n_frames, data_skip_step and
        max_frames honoured): the PNGs decode on TumLoader's threads, ahead
        of the encodes, in order. Returns the loader's waits: {"waits":
        frames asked for before their decode finished, "wait_s": seconds
        spent waiting for them}."""
        p = self.params
        idxs = list(range(p["skip_first_n_frames"], len(dataset), max(1, p["data_skip_step"])))
        if max_frames:
            idxs = idxs[:max_frames]
        if not idxs:
            return {"waits": 0, "wait_s": 0.0}
        mgr = self.manager
        loader = TumLoader(dataset, idxs)
        expected = [0]

        def enc_at(pos):
            # _run_frames asks for each position once, in order
            if pos != expected[0]:
                raise RuntimeError(f"frame {pos} asked for out of order (next {expected[0]})")
            expected[0] += 1
            _ts, rgb, depth = next(loader)
            return mgr.encode(rgb, depth)

        try:
            self._run_frames([dataset.pairs[i][0] for i in idxs], enc_at, None)
        finally:
            loader.close()
        return {"waits": loader.waits, "wait_s": loader.wait_s}

    def _run_frames(self, stamps, enc_at, gt0) -> None:
        """The frames of a source, in order: enc_at(pos) is frame pos's host
        wire, asked for once a position, in increasing order; gt0 anchors
        the first node. Where the manager can group them, frames go
        tpu_frames_per_step at a time through one step call. With
        tpu_encode_ahead one worker thread keeps the next two host encodes
        in flight (the same wires, so the same result)."""
        p = self.params
        mgr = self.manager
        n = len(stamps)
        ngroup = int(p["tpu_frames_per_step"])
        ex = (ThreadPoolExecutor(1, thread_name_prefix="encode-ahead")
              if p["tpu_encode_ahead"] and n > 1 else None)
        futs = {}

        def get_enc(pos):
            if ex is None:
                return enc_at(pos)
            f = futs.pop(pos, None)
            out = f.result() if f is not None else enc_at(pos)
            for q in (pos + 1, pos + 2):
                if q < n and q not in futs:
                    futs[q] = ex.submit(enc_at, q)
            return out

        try:
            k = 0
            while k < n:
                cpt = get_enc(k)
                g = min(ngroup, n - k)
                if g >= 2 and mgr.can_group(g):
                    cpts = [cpt] + [get_enc(k + m) for m in range(1, g)]
                    self._process_group(cpts, [float(t) for t in stamps[k : k + g]])
                    k += g
                    continue
                gt = gt0 if mgr.n_nodes == 0 else None
                self.process_frame(None, None, float(stamps[k]), gt, compact=cpt)
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
        if self.params["octomap_online_creation"]:  # every grouped node entered
            for nid in range(self.manager.n_nodes - len(compacts), self.manager.n_nodes):
                self._online_octomap_insert(nid)

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

    # ------------------------------------------------------------------
    # outputs (graph_mgr_io.cpp)
    @torch.inference_mode()
    def _node_world_cloud(self, node_id: int):
        """A node's cloud rebuilt from its stored stride-s depth and colour
        and its current pose (updateCloudOrigin + transform,
        graph_mgr_io.cpp:216), on the pipeline's device: (points (M, 3),
        colours (M, 3) u8, valid (M,), camera origin (3,)). Without
        store_pointclouds the colours are zeros."""
        mgr = self.manager
        cs = mgr.cam_small
        depth = mgr.store.depth[node_id].view(cs.height, cs.width)
        pose = mgr.graph.poses[node_id]
        pts = se3.apply(pose, backproject_grid(depth, cs).reshape(-1, 3))
        if mgr.store.color.shape[1] > 3:
            cols = mgr.store.color[node_id].view(-1, 3)
        else:  # store_pointclouds=false: no colours were kept
            cols = torch.zeros((cs.height * cs.width, 3), dtype=torch.uint8, device=self.device)
        return pts, cols, (depth > 0).reshape(-1), pose[:3, 3]

    def save_octomap(self, path, map_config: Optional[VoxelMapConfig] = None,
                     node_stride: int = 1) -> VoxelMap:
        """Ray-cast every node_stride-th node cloud into a colour voxel map
        on the pipeline's device and save it as .ot (saveOctomapImpl,
        graph_mgr_io.cpp:253-310). Returns the map (an empty one with
        octomap_clear_after_save, graph_mgr_io.cpp:303)."""
        cfg = map_config or self.map_config()
        vmap = VoxelMap(cfg, device=self.device)
        for nid in range(0, self.manager.n_nodes, node_stride):
            vmap.insert_cloud(*self._node_world_cloud(nid))
        vmap.save(path)
        if self.params["octomap_clear_after_save"]:
            self._online_map = None
            return VoxelMap(cfg, device=self.device)
        return vmap

    def save_clouds(self, path, voxel: Optional[float] = None, fmt: str = "pcd",
                    occupancy_map: Optional[VoxelMap] = None) -> int:
        """The aggregate world cloud as PCD or PLY (saveAllCloudsToFile),
        voxel-downsampled at voxelfilter_size (or `voxel`) when > 0. With
        occupancy_map, points in voxels whose occupancy is at most
        occupancy_filter_threshold are dropped (occupancyFilterClouds,
        graph_manager.cpp:1376). Returns the point count."""
        from ..io.pointcloud import voxel_downsample, write_pcd, write_ply

        thr = self.params["occupancy_filter_threshold"]
        all_p, all_c = [], []
        for nid in range(self.manager.n_nodes):
            pts, cols, valid, _ = self._node_world_cloud(nid)
            if occupancy_map is not None:
                valid = occupancy_map.occupancy_filter(pts, valid, thr)
            all_p.append(pts[valid].cpu().numpy())
            all_c.append(cols[valid].cpu().numpy())
        pts = np.concatenate(all_p, 0) if all_p else np.zeros((0, 3))
        cols = np.concatenate(all_c, 0) if all_c else np.zeros((0, 3), np.uint8)
        v = self.params["voxelfilter_size"] if voxel is None else voxel
        if v and v > 0:
            pts, cols = voxel_downsample(pts, cols, v)
        (write_ply if fmt == "ply" else write_pcd)(path, pts, cols)
        return len(pts)

    def save_individual_clouds(self, out_dir, fmt: str = "pcd") -> List[str]:
        """One world-frame cloud file a node (saveIndividualCloudsToFile,
        graph_mgr_io.cpp:330); returns the paths."""
        from ..io.pointcloud import write_pcd, write_ply

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        files = []
        for nid in range(self.manager.n_nodes):
            pts, cols, valid, _ = self._node_world_cloud(nid)
            path = out / f"node_{nid:04d}.{fmt}"
            (write_ply if fmt == "ply" else write_pcd)(path, pts[valid].cpu().numpy(),
                                                       cols[valid].cpu().numpy())
            files.append(str(path))
        return files

    def save_g2o(self, path) -> None:
        """The pose graph in g2o text format (saveG2OGraph): every node, the
        fixed ones, the active edges."""
        from ..graph.g2o_io import write_g2o

        mgr = self.manager
        mgr._drain_pending()
        g = mgr.graph
        n, m = mgr.n_nodes, mgr.n_edges
        fixed = np.nonzero(g.node_fixed[:n].cpu().numpy())[0].tolist()
        active = g.edge_active[:m].cpu().numpy()
        ei, ej = g.edge_i[:m].cpu().numpy(), g.edge_j[:m].cpu().numpy()
        meas, info = g.edge_meas[:m].cpu().numpy(), g.edge_info[:m].cpu().numpy()
        write_g2o(path, mgr.poses(), fixed,
                  [(int(ei[e]), int(ej[e]), meas[e], info[e]) for e in range(m) if active[e]])

    @torch.inference_mode()
    def save_features(self, path) -> None:
        """World-frame feature positions, descriptors and node ids as .npz
        (saveAllFeaturesToFile, graph_mgr_io.cpp:445-497), with the JAX
        package's keys and dtypes (a bf16 store's descriptors as the raw
        2-byte words numpy writes for JAX's bfloat16)."""
        mgr = self.manager
        mgr._drain_pending()
        n = mgr.n_nodes
        valid = mgr.store.kp_valid[:n].cpu().numpy()
        xyz = se3.apply(mgr.graph.poses[:n], mgr.store.xyz[:n]).cpu().numpy()
        desc = tensor_to_numpy(mgr.store.desc[:n])
        ids = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], valid.shape)
        np.savez_compressed(
            path,
            positions=xyz[valid] if n else np.zeros((0, 3)),
            descriptors=desc[valid] if n else np.zeros((0, mgr.store.desc.shape[-1])),
            node_ids=ids[valid] if n else np.zeros(0, np.int32))
