"""GraphManager: the keep-all-nodes fast path of the SLAM pose graph.

Port of the keep-all path of ``rgbdslam_v2_tpu/graph/manager.py``:
``__init__``, the first-frame branch of ``add_frame``,
``_add_frame_device``, ``_drain_pending`` (synchronous, no staging),
``_drain_batch``, ``_adapt_detector``, ``_apply_fixation``, ``optimize``
(non-inaffected), ``prune_edges_above``, ``poses``, ``trajectory`` and
``statistics``. Host bookkeeping lives in ``graph/host_graph.py``.

Every frame after the first runs ``device_step.slam_step`` on the device;
its (4B+2,) summary is copied to the host asynchronously and read at the
next drain (every ``tpu_drain_interval`` frames, leaving the newest 2 in
flight), so candidate selection sees the same host state as the JAX
package. Configuration outside this slice raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from .. import backend
from ..config import ParameterServer, default_params
from ..core.camera import Intrinsics
from ..models.orb import OrbExtractor
from ..optim.pose_graph import edge_chi2, make_graph_state, optimize
from .device_step import StepSummary, slam_step
from .host_graph import EDGE_CONST_POSITION, HostGraph
from .ingest import compact_frame, prepare_and_extract
from .node_store import NodeStore

logger = logging.getLogger("rgbdslam.graph")


def check_slice(p: ParameterServer, cam: Intrinsics) -> None:
    """Refuse configuration that selects a path this port does not have."""
    s = p["cloud_creation_skip_step"]
    refused = {
        "keep_all_nodes": not p["keep_all_nodes"],
        "tpu_ingest_format": p["tpu_ingest_format"] != "yc12",
        "tpu_gray_bits": p["tpu_gray_bits"] != 8,
        "tpu_depth_bits": p["tpu_depth_bits"] not in (10, 12),
        "tpu_frames_per_step": p["tpu_frames_per_step"] > 1,
        "tpu_wire_delta": p["tpu_wire_delta"],
        "tpu_drain_pipelined": p["tpu_drain_pipelined"],
        "tpu_encode_ahead": p["tpu_encode_ahead"],
        "tpu_edge_info": p["tpu_edge_info"] != "scalar",
        "tpu_emm_exact": p["tpu_emm_exact"],
        "tpu_approx_select": p["tpu_approx_select"],
        "tpu_descriptor_dtype": p["tpu_descriptor_dtype"] != "int8",
        "tpu_mesh_devices": p["tpu_mesh_devices"] > 1,
        "pose_relative_to": p["pose_relative_to"] == "inaffected",
        "use_icp": p["use_icp"],
        "global_loop_candidates": p["global_loop_candidates"] > 0,
        "g2o_transformation_refinement": p["g2o_transformation_refinement"] > 0,
        "use_robot_odom": p["use_robot_odom"] or p["use_robot_odom_only"],
        "min_translation_meter": p["min_translation_meter"] > 0,
        "min_rotation_degree": p["min_rotation_degree"] > 0,
        "clear_non_keyframes": p["clear_non_keyframes"],
        "depth_scaling_factor": p["depth_scaling_factor"] != 1.0,
        "octomap_online_creation": p["octomap_online_creation"],
        "start_paused": p["start_paused"],
        "backend_solver": p["backend_solver"] == "pcg"
        or (p["backend_solver"] == "auto" and p["tpu_max_nodes"] > 1024),
        "cloud_creation_skip_step": cam.height % (2 * s) != 0 or cam.width % (2 * s) != 0,
    }
    families = {p["feature_detector_type"].upper(), p["feature_extractor_type"].upper()}
    refused["feature_extractor_type"] = bool(families & {"SIFT", "SIFTGPU", "BRISK", "FREAK"})
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            "not in this port's slice: " + ", ".join(f"{k}={p[k]!r}" for k in bad))


class GraphManager:
    def __init__(self, cam: Intrinsics, params: Optional[ParameterServer] = None,
                 device=None):
        self.params = params or default_params()
        p = self.params
        check_slice(p, cam)
        self.device = backend.resolve_device(device)
        self.cam = cam
        self.n_cap = p["tpu_max_nodes"]
        self.e_cap = p["tpu_max_edges"]
        self.k_cap = p["max_keypoints"]
        self.cand_batch = p["tpu_candidate_batch"]
        self.emm_stride = s = p["cloud_creation_skip_step"]
        self.depth_bits = p["tpu_depth_bits"]
        self.cam_small = Intrinsics(fx=cam.fx / s, fy=cam.fy / s, cx=cam.cx / s,
                                    cy=cam.cy / s, width=cam.width // s,
                                    height=cam.height // s)
        for f in (p["feature_detector_type"].upper(), p["feature_extractor_type"].upper()):
            if f not in ("ORB", "FAST", "BRIEF"):
                logger.warning("feature family %s not built; falling back to ORB "
                               "(reference behavior, features.cpp:144-160)", f)
        self.extractor = OrbExtractor(
            max_keypoints=self.k_cap, fast_threshold=0.06,
            grid=p["detector_grid_resolution"] + 1,
            oriented=p["feature_extractor_type"].upper() != "BRIEF",
        )
        self._base_threshold = self.extractor.fast_threshold
        self.store = NodeStore.create(
            self.n_cap, self.k_cap, 256, self.cam_small.height, self.cam_small.width,
            store_color=p["store_pointclouds"], device=self.device)
        self.graph = make_graph_state(self.n_cap, self.e_cap, device=self.device)
        self.host = HostGraph(self.e_cap, p, p["tpu_seed"])
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(p["tpu_seed"]))
        self.nodes_since_optimize = 0
        self.last_optimize_iters = 0
        self._pending: list = []  # (new_id, padded, edge_start, host summary)

    # ---- host state, read through the bookkeeping object ----------------
    @property
    def n_nodes(self) -> int:
        return self.host.n_nodes

    @property
    def n_edges(self) -> int:
        return self.host.n_edges

    @property
    def timestamps(self) -> List[float]:
        return self.host.timestamps

    # ------------------------------------------------------------------
    def _step_cfg(self) -> dict:
        p = self.params
        return dict(
            extractor=self.extractor, cam=self.cam, cam_small=self.cam_small,
            stride=self.emm_stride, depth_bits=self.depth_bits,
            min_depth=p["minimum_depth"], max_depth=p["maximum_depth"],
            max_matches=p["max_matches"], ratio=p["nn_distance_ratio"],
            n_hypotheses=p["ransac_iterations"],
            max_mahal_sq=p["max_dist_for_inliers"] ** 2,
            min_inliers=p["min_matches"], emm_skip=p["emm_skip_step"],
            sigma_depth=p["sigma_depth"], sample_size=p["sample_candidates"],
            refine_iterations=p["refine_iterations"],
            observability_threshold=p["observability_threshold"],
            max_translation_per_s=p["max_translation_meter"],
            max_rotation_deg_per_s=p["max_rotation_degree"],
            const_pos_information=p["constant_position_information"],
            use_feature_min_depth=p["use_feature_min_depth"],
        )

    def _to_device(self, arr) -> torch.Tensor:
        """Host array -> device; CUDA copies go through pinned memory, so
        they do not synchronize the stream."""
        a = np.asarray(arr)
        if not a.flags.writeable:
            a = a.copy()
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def add_frame(self, rgb, depth, timestamp: float,
                  ground_truth_pose: Optional[np.ndarray] = None, compact=None) -> bool:
        """Process one frame (rgb/depth, or a pre-packed yc12 buffer);
        every frame enters the graph (keep_all_nodes)."""
        if compact is None:
            compact = compact_frame(rgb, depth, self.emm_stride, self.depth_bits)
        new_id = self.n_nodes
        if new_id >= self.n_cap:
            raise RuntimeError("node capacity exceeded")
        packed = self._to_device(compact)
        if new_id == 0:
            self._add_first_frame(packed, timestamp, ground_truth_pose)
        else:
            self._add_frame_device(packed, timestamp, new_id, new_id - 1)
        return True

    def _add_first_frame(self, packed, timestamp, ground_truth_pose):
        """firstNode (graph_manager.cpp:360-402): fixed at GT or identity."""
        p = self.params
        kp, depth_small, color_small = prepare_and_extract(
            self.extractor, self.cam, self.emm_stride, p["minimum_depth"],
            p["maximum_depth"], p["use_feature_min_depth"], packed, self.depth_bits)
        pose = (np.asarray(ground_truth_pose, np.float32) if ground_truth_pose is not None
                else np.eye(4, dtype=np.float32))
        self.store.insert(0, kp, depth_small, color_small)
        self.graph.poses[0] = self._to_device(pose)
        self.graph.node_active[0] = True
        self.graph.node_fixed[0] = True
        self.host.n_nodes = 1
        self.host.timestamps.append(timestamp)
        self.host.keyframes = [0]

    def _add_frame_device(self, packed, timestamp, new_id, pred_id) -> None:
        p = self.params
        B = self.cand_batch
        padded, dup, dts = self.host.frame_slots(new_id, timestamp, B)
        if self.n_edges + B + 1 > self.e_cap:
            raise RuntimeError("edge capacity exceeded")
        edge_start = self.host.reserve_edges(B)
        summary = slam_step(
            self.store, self.graph, packed, new_id, pred_id,
            self._to_device(np.asarray(padded, np.int64)),
            self._to_device(np.asarray(dup, bool)),
            self._to_device(np.asarray(dts, np.float32)),
            edge_start, self.generator, **self._step_cfg())
        self._pending.append((new_id, padded, edge_start, self._start_copy(summary)))
        self.host.n_nodes += 1
        self.host.timestamps.append(timestamp)
        if len(self._pending) >= p["tpu_drain_interval"]:
            # the newest 2 steps may still be running: leave them pending
            self._drain_pending(keep_newest=2)
        self.nodes_since_optimize += 1
        if self.nodes_since_optimize >= p["optimizer_skip_step"]:
            self.optimize(iterations=p["online_optimizer_iterations"], blocking=False)

    def _start_copy(self, summary: torch.Tensor):
        """Begin the summary's device->host copy; read at drain time."""
        if not summary.is_cuda:
            return summary, None
        host = torch.empty(summary.shape, dtype=summary.dtype, pin_memory=True)
        host.copy_(summary, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _drain_pending(self, keep_newest: int = 0) -> None:
        """Read pending step summaries into the host bookkeeping."""
        if len(self._pending) <= keep_newest:
            return
        if keep_newest:
            pend, self._pending = self._pending[:-keep_newest], self._pending[-keep_newest:]
        else:
            pend, self._pending = self._pending, []
        for new_id, padded, edge_start, (host, event) in pend:
            if event is not None:
                event.synchronize()
            s = StepSummary.unpack(host.numpy(), len(padded))
            self.host.apply_summary(new_id, padded, edge_start, s)
            self._adapt_detector(s.n_valid_kp)

    def _adapt_detector(self, n_valid_kp: int) -> None:
        """Halve the FAST threshold on starvation, step back on saturation
        (DetectorAdjuster semantics, at most adjuster_max_iterations rungs)."""
        p = self.params
        max_rungs = p["adjuster_max_iterations"]
        if max_rungs <= 0:
            return
        t = self.extractor.fast_threshold
        low_bar = max(p["min_keypoints"], 2 * p["min_matches"])
        if p["sufficient_matches"] < self.k_cap:
            low_bar = max(low_bar, p["sufficient_matches"])
        new_t = t
        if n_valid_kp < low_bar:
            new_t = max(t * 0.5, self._base_threshold * (0.5 ** max_rungs))
        elif n_valid_kp >= self.k_cap and t < self._base_threshold:
            new_t = min(t * 2.0, self._base_threshold)
        if new_t != t:
            logger.info("detector threshold %.4f -> %.4f (%d valid keypoints)",
                        t, new_t, n_valid_kp)
            self.extractor = dataclasses.replace(self.extractor, fast_threshold=new_t)

    # ------------------------------------------------------------------
    def _apply_fixation(self) -> None:
        self.graph.node_fixed.copy_(self._to_device(self.host.fixation_mask(self.n_cap)))

    @torch.inference_mode()
    def optimize(self, iterations: Optional[int] = None, blocking: bool = True) -> float:
        """LM pose-graph optimization over the committed nodes. The online
        call (blocking=False) drains all but the newest 2 summaries first,
        like the JAX package; it still waits for its own result."""
        self._drain_pending(keep_newest=0 if blocking else 2)
        p = self.params
        try:
            self._apply_fixation()
            chi2, n_it = optimize(
                self.graph, iterations=iterations or p["optimizer_iterations"],
                huber_delta=p["huber_delta"], n_nodes=self.n_nodes, n_edges=self.n_edges)
            if blocking:
                # the JAX package reports iterations of blocking calls only
                self.last_optimize_iters = int(n_it)
                return float(chi2)
            return float("nan")
        finally:
            self.nodes_since_optimize = 0

    def _add_const_position_edge(self, i: int, j: int) -> None:
        if self.n_edges >= self.e_cap:
            raise RuntimeError("edge capacity exceeded")
        e = self.host.add_edge(i, j, EDGE_CONST_POSITION)
        g = self.graph
        g.edge_i[e], g.edge_j[e] = i, j
        g.edge_meas[e] = torch.eye(4, device=self.device)
        g.edge_info[e] = torch.eye(6, device=self.device) * self.params[
            "constant_position_information"]
        g.edge_active[e] = True

    def prune_edges_above(self, threshold: float) -> int:
        """pruneEdgesWithErrorAbove (graph_manager.cpp:1106-1246): drop
        edges with chi2 above threshold; a pruned consecutive-node edge is
        replaced by a constant-position edge."""
        self._drain_pending()
        chi2 = edge_chi2(self.graph).cpu().numpy()
        active = self.host.edge_active
        n_pruned = 0
        for e in range(self.n_edges):  # edges added below are not revisited
            if active[e] and chi2[e] > threshold:
                i, j = self.host.edge_pairs[e]
                active[e] = False
                if abs(i - j) == 1 and self.host.edge_types[e] != EDGE_CONST_POSITION:
                    self._add_const_position_edge(min(i, j), max(i, j))
                n_pruned += 1
        self.graph.edge_active.copy_(self._to_device(active))
        return n_pruned

    # ------------------------------------------------------------------
    def poses(self) -> np.ndarray:
        return self.graph.poses[: self.n_nodes].cpu().numpy()

    def trajectory(self):
        return list(self.timestamps), self.poses()

    def statistics(self) -> dict:
        self._drain_pending()
        h = self.host
        return {
            "nodes": h.n_nodes,
            "edges": h.n_edges,
            "active_edges": int(h.edge_active.sum()),
            "loop_edges": h.n_loop_edges,
            "sequential_edges": h.n_seq_edges,
            "keyframes": len(h.keyframes),
        }
