"""GraphManager: the SLAM pose graph, fed frame by frame.

Port of ``rgbdslam_v2_tpu/graph/manager.py``: ``__init__`` (with the
feature family and descriptor store, ``make_extractor`` and
``descriptor_layout``), ``add_frame``
(first frame, the keep-all fast path and the host-decision path without
odometry), ``can_group`` and ``add_frame_group`` (N frames a step),
``_commit``, ``_add_frame_device`` (``_add_frames_device``, shared with
the groups), ``_drain_pending`` (blocking or pipelined),
``_consume_ready_staged``, ``_drain_batch``, ``_starvation_alert``,
``_adapt_detector``, ``_apply_fixation``, the ICP rescues of ``use_icp``
(``_icp_rescue_batch``, ``_dispatch_retro_rescue``, ``_consume_rescues``;
the device work is in ``graph/rescue.py``),
``_inaffected_kernel``, ``_optimize_inaffected``, ``optimize``, robot
odometry (``set_odometry_provider``, the odometry-only branch, odometry
edges beside visual ones; ``graph/odometry.py``), the appearance retrieval
of ``global_loop_candidates`` (``graph/loop_closing.py``),
``optimize_landmarks`` (``optim/landmark_ba.py``),
``set_empirical_covariances`` (``optim/covariance.py``),
``prune_edges_above``, ``toggle_mapping``, ``delete_last_frame``,
``clear_feature_information``, ``reset``, ``poses``, ``trajectory``,
``statistics``, ``extract``, ``add_node``, ``sanity_check``,
``memory_footprint``, ``save_state`` and ``load_state``; the host encode
applies ``depth_scaling_factor`` (``maybe_scale_depth``); the wire
fallbacks of ``__init__`` (ydct to yc12, yc12/ydct to raw, 5-bit to 6-bit
luma, the delta wire off or implying 6/10 bits) and the delta wire's
``_wire_encode``, host mirror and device state. Host bookkeeping and the
per-frame decisions live in ``graph/host_graph.py``.

A checkpoint (``save_state``) keeps the JAX package's ``__meta__`` keys; the
port's arrays carry their field names (``store_uv``, ``graph_poses``, ...),
and its meta adds, under ``"port"``, what a continued run needs to go on
exactly as the saved one would (the adapted FAST threshold, the RNG states,
the starvation tracker, the optimize cadence). ``load_state`` also reads a
checkpoint the JAX package saved (``interop.jax_checkpoint_arrays``).

Two per-frame paths, chosen as in the JAX package:

* keep-all fast path (``keep_all_nodes`` with no motion gate, mapping on):
  every frame runs ``device_step.slam_step`` on the device, one frame or
  ``tpu_frames_per_step`` frames a call (on the card a group is one CUDA
  graph replay, ``device_step.StepGraph``). Its (4B+2,) summary reaches the
  host at a drain (every ``tpu_drain_interval`` frames, leaving the newest
  2 in flight): copied to the host as soon as the step is queued, or, with
  ``tpu_drain_pipelined``, stacked at the drain, copied into pinned
  memory in one asynchronous copy and read one step call later
  (``_landed``), waiting there for the copy's event, which has almost
  always passed by then. The lag is fixed: the JAX package reads a staged
  copy as soon as it reports landed, and on the card that made which
  summaries a frame's candidate selection sees, and so the trajectory,
  depend on how far the host ran ahead (ROADMAP F11). With
  ``global_loop_candidates`` the step call of a group is followed, while
  no retrieval is in flight and the newest id is at least 8, by an eager
  retrieval of the newest node against the store
  (``loop_closing.global_match_scores_from_store``) and the start of its
  counts' copy; the counts are read at the candidate selection one step
  call after the one that follows their dispatch (at once on the CPU),
  waiting there for their event (counted as a drain's wait is), and the
  first frame whose selection has room takes their hits. The JAX package
  reads them as soon as its copy reports ready, which makes the candidates
  depend on timing, as its drains do. With ``use_icp`` a
  drain that finds constant-position fallback edges queues their
  retroactive GICP rescue on the card, behind the steps already queued;
  its verdicts come back in an asynchronous copy read at the next drain,
  which waits for them if the card is still on the rescue. Every wait for
  a copy that has not landed is counted (``copy_waits``), and so is every
  such wait outside a blocking drain that ends with no step left queued,
  so that the card idles until the host queues more (``idle_waits``);
  starved and blocking drains pull synchronously (``blocking_pulls``).
* host-decision path (the default configuration, TRO 2014): extract,
  select candidates on the host, compare on the device, pull the result
  and the keypoint count in ONE device->host copy, decide on the host
  (motion gates, redundancy, keyframes), commit in place, optimize online.
  With ``global_loop_candidates`` a frame whose candidates leave room
  retrieves on the device first and reads the hits in a second copy; with
  ``use_robot_odom`` an odometry edge joins the visual ones, and
  ``use_robot_odom_only`` commits the odometry motion without comparing.
  With ``use_icp``, a frame with visually failed candidates rescues them
  in one batched ICP call and pulls its result in one more copy.

Under ``tpu_wire_delta`` the host encodes a frame when it is dispatched
(``encode``, called once a frame in order): a P wire against the mirror of
the device's codes while the chain is unbroken, else an I wire; frames
off the fast path, a checkpoint load and the first frame break the chain.

With ``tpu_mesh_devices`` > 1 the host-decision path's comparisons shard
their candidates over that many devices (``parallel.sharded``, JAX
``_compare_dispatch``). ``parallel.slam_multi.MultiSequenceSlam`` runs a
GraphManager per sequence over views of its stacked tensors (``state=``)
and drives its keep-all halves, ``_frame_inputs`` and ``_frames_queued``,
around one lockstep step.

Spans (``utils.timing``): ``encode``, ``step.inputs``, ``step.launch``
(the eager step call; on the card ``StepGraph``'s replay), ``drain.wait``,
``drain.apply``, ``optimize.online`` / ``optimize.blocking``; and the
latency ``pose_landed`` of every node, from the token the caller opened
when it took the frame (``timing.begin``; else add_frame or
add_frame_group opens one) to the moment the host learns its pose: its
summary's ``apply_summary``, or at once for the first node and on the
host-decision path.

Configuration outside the port raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import List, Optional

import numpy as np
import torch

from .. import backend
from ..config import ParameterServer, default_params
from ..core.camera import Intrinsics
from ..core.frames import Frame
from ..models.orb import OrbExtractor, feature_depth_map
from ..models.sift import SiftExtractor
from ..models.types import Keypoints
from ..optim.pose_graph import (GraphState, edge_chi2, make_graph_state, optimize,
                                 resolve_solver)
from ..ops import dct_wire
from ..ops.emm import emm_pool_maps
from ..ops.matching import match_descriptors
from ..ops.sift import DESC_DIM
from ..utils import timing
from .compare import CompareResult, CompareSummary, compare_to_candidates
from .device_step import StepGraph, StepSummary, commit_node, group_views, pack_group, slam_stepN
from .host_graph import (EDGE_CONST_POSITION, EDGE_LOOP, EDGE_ODOMETRY, EDGE_SEQUENTIAL,
                         HostGraph, MatchDecision, build_edges, const_position_edge,
                         decide_matches, inaffected_subgraph, is_redundant)
from .ingest import (compact_frame, delta_encode, host_unpack_codes, maybe_scale_depth,
                     prepare_and_extract, wire_delta_len, wire_intra_len)
from .loop_closing import global_match_scores_from_store, ranked_hits, retrieve_loop_candidates
from .node_store import NodeStore
from .odometry import odometry_information
from .rescue import icp_rescue_body, retro_rescue

logger = logging.getLogger("rgbdslam.graph")


def fast_path(p: ParameterServer) -> bool:
    """Whether keep_all_nodes selects the device-decided fast path for the
    frames after the first (with mapping on): no motion gate may need a
    host decision, and odometry edges are added on the host path."""
    return (p["keep_all_nodes"] and not p["use_robot_odom"] and not p["use_robot_odom_only"]
            and p["min_translation_meter"] <= 0 and p["min_rotation_degree"] <= 0)


# optimize_landmarks' re-match: the float32 distance matrices of a chunk of
# node pairs
PAIR_CHUNK_BYTES = 256 << 20

# tpu_descriptor_dtype -> the store's dtype for the binary families
DESC_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "float32": torch.float32}


def make_extractor(p: ParameterServer, k_cap: int):
    """The feature family of feature_detector_type / feature_extractor_type,
    as the JAX package selects it: SIFT wins if either side asks for it
    (SIFT and SIFTGPU are one family); otherwise ORB's pipeline with the
    extractor's descriptor: BRIEF unoriented, BRISK or FREAK; SURF and other
    unknown families warn and fall back to ORB (features.cpp:144-160)."""
    family = (p["feature_detector_type"].upper(), p["feature_extractor_type"].upper())
    if any(f in ("SIFT", "SIFTGPU") for f in family):
        return SiftExtractor(max_keypoints=k_cap,
                             use_root_sift=p["squareroot_descriptor_space"])
    for f in family:
        if f not in ("ORB", "FAST", "BRIEF", "BRISK", "FREAK"):
            logger.warning("feature family %s not built; falling back to ORB "
                           "(reference behavior, features.cpp:144-160)", f)
    return OrbExtractor(
        max_keypoints=k_cap, fast_threshold=0.06, grid=p["detector_grid_resolution"] + 1,
        oriented=family[1] != "BRIEF",
        descriptor={"BRISK": "brisk", "FREAK": "freak"}.get(family[1], "brief"))


def descriptor_layout(extractor, p: ParameterServer):
    """The store's descriptor width and dtype: 128 float32 for SIFT; the
    binary families' 256 or 512 bits in tpu_descriptor_dtype (their +/-1
    values are exact in each)."""
    if isinstance(extractor, SiftExtractor):
        return DESC_DIM, torch.float32
    return extractor.desc_bits, DESC_DTYPES[p["tpu_descriptor_dtype"]]


def check_slice(p: ParameterServer) -> None:
    """Refuse configuration that selects a path this port does not have."""
    refused = {
        "tpu_ingest_format": p["tpu_ingest_format"] not in ("yc12", "ydct", "raw"),
        "tpu_gray_bits": p["tpu_gray_bits"] not in (5, 6, 8),
        "tpu_depth_bits": p["tpu_depth_bits"] not in (10, 12),
        "tpu_edge_info": p["tpu_edge_info"] not in ("scalar", "hessian"),
        "tpu_approx_select": p["tpu_approx_select"],
        "tpu_descriptor_dtype": p["tpu_descriptor_dtype"] not in DESC_DTYPES,
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            "not in this port's slice: " + ", ".join(f"{k}={p[k]!r}" for k in bad))


def wire_format(p: ParameterServer, cam: Intrinsics):
    """(format, gray_bits, depth_bits, delta) of the ingest wire after the
    JAX package's fallbacks (its GraphManager.__init__), each logged: ydct
    needs a frame divisible by 8 (else yc12), yc12 and ydct one divisible by
    2 x stride (else raw), 5-bit luma an area divisible by 8 (else 6); the
    delta wire needs yc12 and aligned sizes (else off) and implies 6/10
    bits, which are written back into the parameters."""
    s = p["cloud_creation_skip_step"]
    fmt, gray_bits, depth_bits = p["tpu_ingest_format"], p["tpu_gray_bits"], p["tpu_depth_bits"]
    H, W = cam.height, cam.width
    if fmt == "ydct" and (H % 8 or W % 8):
        logger.warning("frame %dx%d not divisible by 8; ydct ingest falls back to yc12", W, H)
        fmt = "yc12"
    if fmt in ("yc12", "ydct") and (H % (2 * s) or W % (2 * s)):
        logger.warning("frame %dx%d not divisible by 2*stride=%d; ingest falls back to raw",
                       W, H, 2 * s)
        fmt = "raw"
    if gray_bits == 5 and (H * W) % 8:
        logger.warning("frame area %% 8 != 0; tpu_gray_bits=5 falls back to 6")
        gray_bits = 6
    delta = bool(p["tpu_wire_delta"])
    if delta and not (fmt == "yc12" and (H * W) % 2 == 0 and ((H // s) * (W // s)) % 8 == 0):
        logger.warning("tpu_wire_delta needs the yc12 format and aligned frame sizes; disabled")
        delta = False
    if delta and (gray_bits, depth_bits) != (6, 10):
        logger.warning("tpu_wire_delta implies gray_bits=6/depth_bits=10 (requested %d/%d): "
                       "expect an L1-ATE cost vs the 8/12 defaults", gray_bits, depth_bits)
        gray_bits, depth_bits = 6, 10
        p.set("tpu_gray_bits", 6)
        p.set("tpu_depth_bits", 10)
    return fmt, gray_bits, depth_bits, delta


def _inaffected_kernel(graph: GraphState, gi, ge, li, lj, nfix, nact, eact, free_mask,
                       iterations: int, huber_delta: float, pcg_iters: int,
                       solver: str, read_convergence: bool = True):
    """Gather the affected subgraph, optimize it, scatter the free poses
    back in place (pose_relative_to=inaffected, graph_manager.cpp:889-992);
    returns optimize's (chi2, iterations). Duplicate ids in gi (the
    padding) all write the same unchanged pose."""
    sub = GraphState(
        poses=graph.poses[gi], node_active=nact, node_fixed=nfix, edge_i=li, edge_j=lj,
        edge_meas=graph.edge_meas[ge], edge_info=graph.edge_info[ge], edge_active=eact)
    chi2, n_it = optimize(sub, iterations=iterations, huber_delta=huber_delta,
                          pcg_iters=pcg_iters, solver=solver, read_convergence=read_convergence)
    graph.poses[gi] = torch.where(free_mask[:, None, None], sub.poses, graph.poses[gi])
    return chi2, n_it


class GraphManager:
    def __init__(self, cam: Intrinsics, params: Optional[ParameterServer] = None,
                 device=None, extractor=None, state=None):
        """state: a (NodeStore, GraphState) pair to keep the graph in
        instead of allocating one (a sequence of
        parallel.slam_multi.MultiSequenceSlam: views of its stacked
        tensors, on `device`, whose steps the caller runs)."""
        self.params = params or default_params()
        p = self.params
        check_slice(p)
        self.device = backend.resolve_device(device)
        # tpu_mesh_devices > 1: the host-decision path's comparisons shard
        # their candidates over a mesh of that many devices of this
        # manager's kind (CPU shards on the CPU, else the first cards;
        # ValueError where there are fewer)
        self.mesh = None
        if p["tpu_mesh_devices"] > 1 and state is None:
            from ..parallel.mesh import candidate_mesh

            self.mesh = candidate_mesh(p["tpu_mesh_devices"],
                                       platform="cpu" if self.device.type == "cpu" else None)
        self.cam = cam
        self.n_cap = p["tpu_max_nodes"]
        self.e_cap = p["tpu_max_edges"]
        self.k_cap = p["max_keypoints"]
        self.cand_batch = p["tpu_candidate_batch"]
        self.emm_stride = s = p["cloud_creation_skip_step"]
        self.ingest_fmt, self.gray_bits, self.depth_bits, self.wire_delta = wire_format(p, cam)
        # the ydct luma's rate/quality point, carried to the encoder, the
        # decoder and the starvation alert (ValueError when unknown)
        self.dct = (dct_wire.spec(p["tpu_dct_quality"]) if self.ingest_fmt == "ydct"
                    else None)
        self.cam_small = Intrinsics(fx=cam.fx / s, fy=cam.fy / s, cx=cam.cx / s,
                                    cy=cam.cy / s, width=cam.width // s,
                                    height=cam.height // s)
        self.extractor = extractor or make_extractor(p, self.k_cap)
        # the adaptive FAST ladder's base; None for SIFT, which has no FAST
        self._base_threshold = getattr(self.extractor, "fast_threshold", None)
        if state is None:
            desc_dim, desc_dtype = descriptor_layout(self.extractor, p)
            self.store = NodeStore.create(
                self.n_cap, self.k_cap, desc_dim, self.cam_small.height, self.cam_small.width,
                store_color=p["store_pointclouds"], device=self.device, desc_dtype=desc_dtype)
            self.graph = make_graph_state(self.n_cap, self.e_cap, device=self.device)
        else:
            self.store, self.graph = state
        self.host = HostGraph(self.e_cap, p, p["tpu_seed"])
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(p["tpu_seed"]))
        self.nodes_since_optimize = 0
        self.last_optimize_iters = 0
        self.solver_calls = {"dense": 0, "pcg": 0}  # optimize calls by solver
        # online (blocking=False) optimize calls, and the LM iterations they ran
        self.online_optimizes = 0
        self.online_lm_iterations = 0
        self.last_decisions: List[MatchDecision] = []
        self.mapping_enabled = True  # toggleMapping (localization-only mode)
        # localizationUpdate outputs (graph_manager.cpp:660-679)
        self.localization_pose: Optional[np.ndarray] = None
        self.localization_trajectory: List[tuple] = []
        self._loc_poses_host: Optional[np.ndarray] = None  # frozen-map mirror
        # pose_relative_to=inaffected: nodes optimized so far
        self._nodes_opt_watermark = 0
        # first-node replacement (graph_manager.cpp:762-769)
        self._kp_count0 = -1
        self._first_pose = np.eye(4, dtype=np.float32)
        # (new_id, padded, edge_start, summary): a device tensor row while
        # the copy waits for a pipelined drain, else (host row, event)
        self._pending: list = []
        # [(pend, host stack, event, step call it was staged in)] copies
        # not read yet; step calls queued so far (the staged copies' clock)
        self._staged: list = []
        self._step_calls = 0
        self._contrast_ema: Optional[float] = None  # host luma contrast (starvation alert)
        self._starved_mode = False  # contrast collapsed: drains go synchronous
        # use_icp on the fast path: (T, ok, node id) of the last retroactive
        # rescue (the chain's seed across dispatches), and the dispatched
        # rescues whose verdicts are not read yet: (new_ids, slots, host
        # flags, event)
        self._last_rescue = None
        self._pending_rescues: list = []
        self.n_icp_rescues = 0  # accepted ICP rescues, both paths
        self.rescue_items = 0  # fallback edges sent to the retroactive rescue
        # the fast path's waits for the card: blocking device->host copies
        # of drains (starved mode, contrast alerts, unpipelined drains), and
        # reads of an asynchronous copy that had not landed yet
        self.blocking_pulls = 0
        self.copy_waits = 0
        self.idle_waits = 0
        self._step_done = None  # event after the newest queued step (CUDA)
        # the delta wire: the host mirror of the device's codes, whether the
        # device holds them (the chain is unbroken), and the device codes
        # each step reads and overwrites
        self._wire_qg: Optional[np.ndarray] = None
        self._wire_qd: Optional[np.ndarray] = None
        self._wire_synced = False
        self.wire_state = None
        if self.wire_delta:
            self.wire_state = (
                torch.zeros((cam.height, cam.width), dtype=torch.uint8, device=self.device),
                torch.zeros((cam.height // s, cam.width // s), dtype=torch.int32,
                            device=self.device))
        self.odometry = None  # OdometryProvider (use_robot_odom*)
        # the keep-all path's retrieval in flight: (host counts, event, step
        # calls queued at its dispatch), or None; retrievals run
        # and the hits they added to candidates, on either path
        self._retrieval = None
        self.retrievals = 0
        self.retrieval_hits = 0
        self.step_graph = (StepGraph(self.store, self.graph, self.generator, self.wire_state)
                           if self.device.type == "cuda" and state is None else None)
        # node id -> the pose_landed token of its frame, until the host
        # learns the node's pose
        self._landing: dict = {}

    def set_odometry_provider(self, provider) -> None:
        """Attach an OdometryProvider (use_robot_odom, use_robot_odom_only)."""
        self.odometry = provider

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

    @property
    def keyframes(self) -> List[int]:
        return self.host.keyframes

    # ------------------------------------------------------------------
    def _compare_kwargs(self) -> dict:
        """Matching, RANSAC and EMM settings of compare_to_candidates."""
        p = self.params
        return dict(
            max_matches=p["max_matches"], ratio=p["nn_distance_ratio"],
            n_hypotheses=p["ransac_iterations"],
            max_mahal_sq=p["max_dist_for_inliers"] ** 2,
            min_inliers=p["min_matches"], emm_skip=p["emm_skip_step"],
            sigma_depth=p["sigma_depth"], sample_size=p["sample_candidates"],
            refine_iterations=p["refine_iterations"],
            projective_iterations=p["g2o_transformation_refinement"],
            emm_exact=bool(p["tpu_emm_exact"]), edge_info_mode=p["tpu_edge_info"])

    def _step_cfg(self) -> dict:
        p = self.params
        return dict(
            extractor=self.extractor, cam=self.cam, cam_small=self.cam_small,
            stride=self.emm_stride, depth_bits=self.depth_bits, dct=self.dct,
            gray_bits=self.gray_bits, fmt=self.ingest_fmt,
            min_depth=p["minimum_depth"], max_depth=p["maximum_depth"],
            **self._compare_kwargs(),
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

    def _extract(self, packed):
        p = self.params
        return prepare_and_extract(
            self.extractor, self.cam, self.emm_stride, p["minimum_depth"],
            p["maximum_depth"], p["use_feature_min_depth"], packed, self.depth_bits, self.dct,
            self.gray_bits, self.ingest_fmt)

    def encode(self, rgb, depth, scale_depth: bool = True) -> np.ndarray:
        """The host wire of one frame (yc12, ydct or raw, as configured),
        its depth scaled by depth_scaling_factor first (unless scale_depth
        is False: the stereo input's computed metres). Under the delta wire
        it is the wire of the next frame to be dispatched: call it once a
        frame, in order, just before the frame's add_frame or
        add_frame_group (the host mirror advances with each call)."""
        with timing.span("encode"):
            if scale_depth:
                depth = maybe_scale_depth(depth, self.params["depth_scaling_factor"])
            if self.wire_delta and self.n_nodes > 0 and self.mapping_enabled and fast_path(
                    self.params):
                return self._wire_encode(rgb, depth)
            return compact_frame(rgb, depth, self.emm_stride, self.depth_bits, self.dct,
                                 self.gray_bits, self.ingest_fmt)

    def _wire_encode(self, rgb, depth) -> np.ndarray:
        """The delta wire of a fast-path frame: a P wire against the mirror
        while the device holds the mirrored codes and the clamp budget
        holds, else an I wire, whose codes become the mirror."""
        H, W, s = self.cam.height, self.cam.width, self.emm_stride
        if self._wire_synced and self._wire_qg is not None:
            out = delta_encode(rgb, depth, self._wire_qg, self._wire_qd, s,
                               self.params["tpu_wire_delta_max_clamp"])
            if out is not None:
                packed, self._wire_qg, self._wire_qd = out
                return packed
        packed = compact_frame(rgb, depth, s, 10, None, 6)
        self._wire_qg, self._wire_qd = host_unpack_codes(packed, H, W, s)
        # the frame is dispatched on the fast path next, and the device
        # rebuilds its codes from the I wire
        self._wire_synced = True
        return packed

    def wire_mark(self):
        """The delta wire's host state (the mirror of the card's codes, and
        whether the card holds it), for wire_rewind; None without the delta
        wire. The mirror is copied: the native encoder advances it in place."""
        if not self.wire_delta:
            return None
        return (None if self._wire_qg is None else self._wire_qg.copy(),
                None if self._wire_qd is None else self._wire_qd.copy(), self._wire_synced)

    def wire_rewind(self, mark) -> None:
        """Undo the encodes since wire_mark, for a frame encoded and then not
        dispatched (dropped while paused): the mirror must follow the codes
        the card holds, or the next P wire decodes against other codes."""
        if mark is not None:
            self._wire_qg, self._wire_qd, self._wire_synced = mark

    @torch.inference_mode()
    def extract(self, frame: Frame) -> Keypoints:
        """Keypoints of a full-resolution Frame (gray and depth) with the
        current extractor, on this manager's device."""
        dev = self.device
        fdepth = feature_depth_map(frame.depth.to(dev), frame.valid.to(dev),
                                   self.params["use_feature_min_depth"])
        return self.extractor(frame.gray.to(dev), fdepth, self.cam)

    def add_node(self, frame: Frame, timestamp: float,
                 ground_truth_pose: Optional[np.ndarray] = None) -> bool:
        """add_frame on a Frame's rgb and (clipped) depth."""
        img = frame.rgb if frame.rgb.ndim == 3 else frame.gray
        return self.add_frame(img.cpu().numpy(), frame.depth.cpu().numpy(), timestamp,
                              ground_truth_pose)

    def add_frame(self, rgb, depth, timestamp: float,
                  ground_truth_pose: Optional[np.ndarray] = None, compact=None,
                  token=None) -> bool:
        """Process one frame (rgb/depth, or a pre-packed wire from encode);
        returns True when the node entered the graph (in localization mode:
        when the frame was localized). token: the frame's pose_landed,
        opened (timing.begin) when the caller took it; else opened here."""
        token = token or timing.begin("pose_landed")
        new_id = self.n_nodes
        if compact is None:
            compact = self.encode(rgb, depth)
        if new_id >= self.n_cap:
            raise RuntimeError("node capacity exceeded")
        if new_id == 0:
            self._add_first_frame(self._to_device(compact), timestamp, ground_truth_pose)
            timing.end(token)
            return True
        if self.mapping_enabled and fast_path(self.params):
            self._add_frames_device([compact], [timestamp], [new_id], [token])
            return True
        took = self._add_frame_host(self._to_device(compact), timestamp, new_id)
        if self.n_nodes > new_id:  # the host decided: the pose is known
            timing.end(token)
        return took

    def _add_first_frame(self, packed, timestamp, ground_truth_pose):
        """firstNode (graph_manager.cpp:360-402): fixed at GT or identity."""
        self._wire_synced = False
        kp, depth_small, color_small = self._extract(packed)
        pose = (np.asarray(ground_truth_pose, np.float32) if ground_truth_pose is not None
                else np.eye(4, dtype=np.float32))
        self.store.insert(torch.zeros(1, dtype=torch.long, device=self.device), kp,
                          depth_small, color_small)
        self.graph.poses[0] = self._to_device(pose)
        self.graph.node_active[0].fill_(True)
        self.graph.node_fixed[0].fill_(True)
        self.host.n_nodes = 1
        self.host.timestamps.append(timestamp)
        self.host.keyframes = [0]
        self._nodes_opt_watermark = 1
        self.last_decisions = []
        self._first_pose = pose  # kept for first-node replacement
        self._kp_count0 = int(kp.count())

    # ---- host-decision path ----------------------------------------------
    def _compare_dispatch(self, kp, depth_small, cand_idx: torch.Tensor) -> CompareResult:
        """Matching, RANSAC and EMM of the new frame against B stored nodes;
        with a mesh (tpu_mesh_devices > 1) whose size divides B, the
        candidates shard over it (parallel.sharded.sharded_compare, JAX
        _compare_dispatch)."""
        if self.mesh is not None and self.cand_batch % self.mesh.size == 0:
            from ..parallel.sharded import sharded_compare

            return sharded_compare(
                self.mesh, kp, depth_small, self.store, cand_idx, self.generator,
                self.cam_small, cam_fx=self.cam.fx, cam_fy=self.cam.fy, cam_cx=self.cam.cx,
                cam_cy=self.cam.cy, **self._compare_kwargs())
        return compare_to_candidates(
            kp, depth_small, self.store, cand_idx, self.generator, self.cam_small,
            cam_fx=self.cam.fx, cam_fy=self.cam.fy, cam_cx=self.cam.cx, cam_cy=self.cam.cy,
            **self._compare_kwargs())

    def _add_frame_host(self, packed, timestamp: float, new_id: int) -> bool:
        """nodeComparisons + addNode (graph_manager.cpp:421-809): compare on
        the device, decide on the host. The frame waits for the card once:
        the comparison result and the keypoint count come back in one copy.
        Its stages are spans decide.extract, .select, .compare, .pull (that
        wait), .host (the decisions, the ICP rescue included) and .commit,
        each with the new node's id."""
        p = self.params
        self._wire_synced = False  # frames off the fast path bypass the delta state
        B = self.cand_batch
        with timing.span("decide.extract", new_id):
            kp, depth_small, color_small = self._extract(packed)
        if p["use_robot_odom_only"]:
            return self._add_odometry_only(kp, depth_small, color_small, timestamp, new_id)
        n_global = p["global_loop_candidates"]
        appearance = None
        if n_global > 0 and new_id > 4:
            def appearance(out):
                self.retrievals += 1
                hits = [h for h in retrieve_loop_candidates(
                    kp, self.store, self.n_nodes, out + [new_id],
                    top_n=min(n_global, B - len(out))) if h not in out]
                self.retrieval_hits += len(hits)
                return hits
        with timing.span("decide.select", new_id):
            cand_ids = self.host.select_candidates(new_id, B, appearance)
            padded = (cand_ids + [cand_ids[0]] * B)[:B]
        with timing.span("decide.compare", new_id):
            res = self._compare_dispatch(kp, depth_small,
                                         self._to_device(np.asarray(padded, np.int64)))
        with timing.span("decide.pull", new_id):
            cmp = CompareSummary.unpack(CompareSummary.pack(res, kp.count()).cpu().numpy(), B)

        with timing.span("decide.host", new_id):
            self._adapt_detector(cmp.n_valid_kp)
            pred_id = new_id - 1
            dt_pred = max(timestamp - self.timestamps[pred_id], 1e-3)
            decisions, accepted = decide_matches(padded, cmp, timestamp, self.timestamps,
                                                 pred_id, p)
            self.last_decisions = decisions

            if not self.mapping_enabled:
                return self._localize(padded, accepted, cmp, timestamp)
            if is_redundant(padded, accepted, cmp, pred_id, dt_pred, p):
                return False
            icp = {}  # cand_id -> (T, info6x6, n_pairs, rmse)
            if p["use_icp"]:
                accepted_ids = {padded[b] for b in accepted}
                failed = [d.cand_id for d in decisions
                          if not d.accepted and d.cand_id not in accepted_ids]
                if failed:
                    icp = self._icp_rescue_batch(depth_small, failed, padded, cmp)
                    for cid, (_T, _info, n_pairs, rmse) in icp.items():
                        decisions.append(MatchDecision(cand_id=cid, accepted=True,
                                                       reason="icp", n_inliers=n_pairs,
                                                       rmse=rmse))
            base_id, base_T_new, edges = build_edges(
                padded, accepted, cmp, pred_id, new_id,
                self.host.geodesic_set(pred_id, p["geodesic_depth"]), icp)
            if not edges:
                if p["keep_all_nodes"] or (p["keep_good_nodes"]
                                           and cmp.n_valid_kp > p["min_keypoints"]):
                    edges.append(const_position_edge(pred_id, new_id, dt_pred, p))
                else:
                    # first-node replacement (graph_manager.cpp:762-769): while
                    # the graph holds only the first node, an unmatched frame
                    # with more features replaces it. Posed as the JAX package
                    # does: poses[0] @ the first frame's pose.
                    if new_id == 1 and cmp.n_valid_kp > self._kp_count0:
                        self._commit(kp, depth_small, color_small, 0, 0, self._first_pose, [])
                        self.timestamps[0] = timestamp
                        self._kp_count0 = cmp.n_valid_kp
                    return False
            if p["use_robot_odom"] and self.odometry is not None:
                # an odometry edge beside the visual ones (graph_mgr_odom.cpp:62)
                odo = self._odometry_edge(pred_id, new_id, timestamp, dt_pred)
                if odo is not None:
                    edges.append(odo)

        with timing.span("decide.commit", new_id):
            self._commit(kp, depth_small, color_small, new_id, base_id, base_T_new, edges)
            self.n_icp_rescues += len(icp)
            self.host.n_nodes += 1
            self.timestamps.append(timestamp)
            self.host.add_keyframe([padded[b] for b in accepted], pred_id)
            if p["clear_non_keyframes"]:
                ids = self.host.non_keyframes_to_clear(new_id)
                if ids is not None:
                    self.store.clear_features(self._to_device(np.asarray(ids, np.int64)))
        self.nodes_since_optimize += 1
        if self.nodes_since_optimize >= p["optimizer_skip_step"]:
            self.optimize(iterations=p["online_optimizer_iterations"], blocking=False,
                          pcg_iters=24)
        return True

    def _odometry_edge(self, pred_id: int, new_id: int, timestamp: float, dt: float):
        """(pred, new, odometry motion, information, EDGE_ODOMETRY), or None
        where the provider has no pose at either stamp."""
        delta = self.odometry.delta(self.timestamps[pred_id], timestamp)
        if delta is None:
            return None
        info = odometry_information(dt, self.params["odometry_information_factor"])
        return (pred_id, new_id, np.asarray(delta, np.float32), info, EDGE_ODOMETRY)

    def _add_odometry_only(self, kp, depth_small, color_small, timestamp: float,
                           new_id: int) -> bool:
        """use_robot_odom_only (graph_mgr_odom): the node is posed by the
        odometry motion from its predecessor and joined to it by one
        odometry edge, without a comparison."""
        if self.odometry is None:
            raise RuntimeError("use_robot_odom_only without an odometry provider")
        pred_id = new_id - 1
        edge = self._odometry_edge(pred_id, new_id, timestamp,
                                   max(timestamp - self.timestamps[pred_id], 1e-3))
        if edge is None:
            return False
        self._commit(kp, depth_small, color_small, new_id, pred_id, edge[2], [edge])
        self.host.n_nodes += 1
        self.timestamps.append(timestamp)
        return True

    def _icp_rescue_batch(self, depth_small, failed_ids: List[int], padded: List[int],
                          cmp: CompareSummary) -> dict:
        """use_icp on the host-decision path: ICP-rescue the visually failed
        candidates (at most B, padded with the first) in ONE batched call,
        seeded by their failed RANSAC transform where RANSAC was ok, else
        identity, and read the results in ONE device->host copy. Returns
        {cand_id: (T, info6x6, n_pairs, rmse)} for the converged results
        that pass the EMM gate."""
        p = self.params
        B = self.cand_batch
        ids = list(dict.fromkeys(failed_ids))[:B]
        pad_ids = (ids + [ids[0]] * B)[:B]
        eye4 = np.eye(4, dtype=np.float32)
        seeds = []
        for cid in pad_ids:
            b = padded.index(cid) if cid in padded else 0
            seeds.append(np.asarray(cmp.transform[b], np.float32) if cmp.ransac_ok[b] else eye4)
        h, w = self.cam_small.height, self.cam_small.width
        idx = self._to_device(np.asarray(pad_ids, np.int64))
        r = icp_rescue_body(
            self._to_device(np.stack(seeds)), depth_small, self.store.depth[idx].view(B, h, w),
            self.cam_small, int(p["icp_max_iterations"]), p["emm_skip_step"],
            p["sigma_depth"], str(p["icp_variant"]),
            new_lohi=emm_pool_maps(depth_small).reshape(1, -1).expand(B, -1),
            cand_lohi=self.store.emm_lohi[idx])
        host = torch.cat([r.transform.reshape(-1), r.rmse, r.n_pairs.float(),
                          r.converged.float(), r.emm_quality, r.emm_inlier_frac]).cpu().numpy()
        T = host[: 16 * B].reshape(B, 4, 4)
        rmse, n_pairs, conv, q, frac = host[16 * B :].reshape(5, B)
        thr = p["observability_threshold"]
        res = {}
        for k, cid in enumerate(ids):
            if conv[k] < 0.5 or (thr > 0 and not (q[k] > thr and frac[k] > 0.25)):
                continue
            info_scale = min(float(n_pairs[k]) / (float(rmse[k]) ** 2 + 4e-4), 1e6)
            res[cid] = (T[k].copy(), np.eye(6, dtype=np.float32) * info_scale,
                        int(n_pairs[k]), float(rmse[k]))
        return res

    def _localize(self, padded, accepted, cmp, timestamp) -> bool:
        """localizationUpdate (graph_manager.cpp:660-679): the pose from the
        best accepted match against the frozen map; the graph does not grow."""
        if not accepted:
            return False
        best_b = max(accepted, key=lambda b: cmp.n_inliers[b])
        if self._loc_poses_host is None:
            self._loc_poses_host = self.poses()
        pose = (np.asarray(self._loc_poses_host[padded[best_b]], np.float32)
                @ np.asarray(cmp.transform[best_b], np.float32))
        self.localization_pose = pose
        self.localization_trajectory.append((timestamp, pose))
        return True

    def _commit(self, kp, depth_small, color_small, new_id: int, base_id: int,
                base_T_new: np.ndarray, edges) -> None:
        """Node insert + pose + up to B+2 edges, written in place from one
        host->device copy; then the host mirrors of the edges."""
        B_e = self.cand_batch + 2
        edges = edges[:B_e]
        if self.n_edges + len(edges) > self.e_cap:
            raise RuntimeError("edge capacity exceeded")
        n = min(B_e, self.e_cap - self.n_edges)
        # [base_T_new 16 | base_id, new_id, first edge slot | n rows of
        # (i, j, active, meas 16, info 36)]; ids < 2^24 are exact in float32
        buf = np.zeros(19 + 55 * n, np.float32)
        buf[:16] = np.asarray(base_T_new, np.float32).reshape(-1)
        buf[16:19] = base_id, new_id, self.n_edges
        rows = buf[19:].reshape(n, 55)
        rows[:, 3:19] = np.eye(4, dtype=np.float32).reshape(-1)
        for k, (i, j, meas, info, _t) in enumerate(edges):
            rows[k, :3] = (i, j, 1.0)
            rows[k, 3:19] = np.asarray(meas, np.float32).reshape(-1)
            rows[k, 19:] = np.asarray(info, np.float32).reshape(-1)
        dev = self._to_device(buf)
        ids = dev[16:19].long()
        e = dev[19:].view(n, 55)
        commit_node(self.store, self.graph, ids[1:2], kp, depth_small, color_small,
                    ids[0:1], dev[:16].view(4, 4), ids[2:3],
                    e[:, 0].to(torch.int32), e[:, 1].to(torch.int32),
                    e[:, 3:19].reshape(n, 4, 4), e[:, 19:].reshape(n, 6, 6), e[:, 2] > 0.5)
        for (i, j, _m, _info, etype) in edges:
            self.host.add_edge(i, j, etype)

    # ---- keep-all fast path ----------------------------------------------
    def can_group(self, n: int = 2) -> bool:
        """True when the next n frames may go through the n-frame step (the
        single fast path's preconditions, an existing node to anchor poses,
        and room for n nodes and their edge slots)."""
        p = self.params
        return (self.n_nodes > 0 and self.mapping_enabled and fast_path(p)
                and not p["use_robot_odom"] and not p["use_robot_odom_only"]
                and self.n_nodes + n <= self.n_cap
                and self.n_edges + n * (self.cand_batch + 1) <= self.e_cap)

    @torch.inference_mode()
    def add_frame_group(self, compacts, tss, tokens=None) -> None:
        """N consecutive frames in ONE step call (tpu_frames_per_step=N;
        on the card one CUDA graph replay). Frame k selects its candidates
        against host state that already holds frames < k (their timestamps;
        adjacency stays one drain stale, as always). The caller checks
        can_group(len(compacts)) first. tokens: the frames' pose_landed,
        as add_frame's token."""
        tokens = tokens or [timing.begin("pose_landed") for _ in compacts]
        self._add_frames_device(list(compacts), list(tss),
                                [self.n_nodes + k for k in range(len(compacts))], tokens)

    def _add_frames_device(self, compacts, tss, ids, tokens) -> None:
        B, n = self.cand_batch, len(ids)
        compacts, host_flat, slots, e_starts, L = self._frame_inputs(
            compacts, tss, ids, pin=self.device.type == "cuda")
        if self.step_graph is not None and n > 1:
            sums = self.step_graph.run(host_flat, n, L, B, self._step_cfg())
        else:
            with timing.span("step.launch", ids[0]):
                flat = host_flat.to(self.device, non_blocking=True)
                sums = slam_stepN(self.store, self.graph, group_views(flat, n, L, B),
                                  self.generator, self.wire_state, **self._step_cfg())
        if self.wire_delta:
            self._wire_synced = True
        self._step_calls += 1
        if self.device.type == "cuda":
            self._step_done = torch.cuda.Event()
            self._step_done.record()
        if self.params["tpu_drain_pipelined"]:
            rows = list(sums)  # copied at the drain, stacked
        else:
            host, event = self._start_copy(sums)
            rows = [(host[k], event) for k in range(n)]
        self._frames_queued(compacts, tss, ids, slots, e_starts, rows, tokens)

    def _frame_inputs(self, compacts, tss, ids, pin: bool):
        """Before the step of frames `ids`: their candidate slots (frame k
        selected against host state holding frames < k), their edge slots
        reserved, and the step's inputs packed into one flat host buffer
        (pinned when `pin`). Returns (compacts as the step takes them,
        buffer, slots, first edge slots, wire length)."""
        with timing.span("step.inputs", ids[0]):
            p = self.params
            B = self.cand_batch
            n = len(ids)
            h = self.host
            if self.n_edges + n * (B + 1) > self.e_cap:
                raise RuntimeError("edge capacity exceeded")
            slots, added = [], 0
            try:  # append frames < k for frame k's selection, roll back after
                for k in range(n):
                    appearance = None
                    if p["global_loop_candidates"] > 0 and self._retrieval is not None:
                        appearance = lambda out, new_id=ids[k]: self._retrieved_hits(out, new_id)
                    slots.append(h.frame_slots(ids[k], tss[k], B, appearance))
                    if k < n - 1:
                        h.timestamps.append(tss[k])
                        h.n_nodes += 1
                        added += 1
            finally:
                del h.timestamps[len(h.timestamps) - added:]
                h.n_nodes -= added
            e_starts = [h.reserve_edges(B) for _ in range(n)]
            intra = None
            if self.wire_delta:
                compacts, intra = self._delta_wires(compacts)
            wires = np.stack(compacts)
            host_flat = pack_group(wires, ids, [s[0] for s in slots], [s[1] for s in slots],
                                   [s[2] for s in slots], e_starts, pin=pin, intra=intra)
            return compacts, host_flat, slots, e_starts, wires.shape[1]

    def _frames_queued(self, compacts, tss, ids, slots, e_starts, rows, tokens) -> None:
        """After the step of frames `ids` is queued (and counted in
        _step_calls): their summaries `rows` pend for a drain (their
        pose_landed `tokens` with them), the host learns the frames, and
        the retrieval, the starvation alert, the drains and the online
        optimize run as their rules say."""
        p = self.params
        h = self.host
        n = len(ids)
        for k in range(n):
            self._pending.append((ids[k], slots[k][0], e_starts[k], rows[k]))
            self._landing[ids[k]] = tokens[k]
            h.n_nodes += 1
            h.timestamps.append(tss[k])
        if p["global_loop_candidates"] > 0 and ids[-1] >= 8 and self._retrieval is None:
            # the deferred retrieval of the newest node, queued behind the step
            counts = global_match_scores_from_store(self.store, ids[-1], self.n_nodes)
            self._retrieval = (*self._start_copy(counts), self._step_calls)
            self.retrievals += 1
        # evaluate every alert (the tracker is stateful) before combining
        if any([self._starvation_alert(c) for c in compacts]):
            # contrast collapsed: flush everything, this group included, so
            # the adaptive ladder reacts on the next frame instead of a
            # drain interval later
            self._drain_pending()
        self._consume_ready_staged()
        if len(self._pending) >= p["tpu_drain_interval"]:
            # the newest 2 steps may still be running: leave them pending
            self._drain_pending(keep_newest=2)
        self._online_optimize(n)

    def _online_optimize(self, n: int) -> None:
        """After n frames entered: the online optimize, once
        optimizer_skip_step frames have entered since the last one."""
        p = self.params
        self.nodes_since_optimize += n
        if self.nodes_since_optimize >= p["optimizer_skip_step"]:
            self.optimize(iterations=p["online_optimizer_iterations"], blocking=False,
                          pcg_iters=24)

    def _retrieved_hits(self, out: List[int], new_id: int) -> List[int]:
        """The retrieval's hits for a keep-all frame's selection, once its
        counts may be read: one step call after the step call that follows
        its dispatch, or at once where the copy has no event (CPU), as
        _landed reads a staged drain; then the retrieval is consumed, and
        the next step call dispatches another. Before that, none."""
        host, event, staged_at = self._retrieval
        if event is not None and staged_at >= self._step_calls:
            return []
        self._wait(event, lagged=True)
        self._retrieval = None
        p = self.params
        hits = ranked_hits(host.numpy(), out, new_id, p["global_loop_candidates"],
                           self.cand_batch, p["tpu_retrieval_min_matches"])
        self.retrieval_hits += len(hits)
        return hits

    def _delta_wires(self, compacts):
        """Delta-wire frames as the step takes them: every wire padded to
        the I length, with its I flag. Where the newest is an I wire, the
        host mirror is read back off it (as the device rebuilds its codes
        from it), so that an I wire the caller encoded itself also
        restarts the chain."""
        H, W, s = self.cam.height, self.cam.width, self.emm_stride
        L_i, L_p = wire_intra_len(H, W, s), wire_delta_len(H, W, s)
        compacts = [np.asarray(c) for c in compacts]
        for c in compacts:
            if len(c) not in (L_i, L_p):
                raise ValueError(f"a delta-wire frame is {L_i} (I) or {L_p} (P) bytes, "
                                 f"not {len(c)}")
        if len(compacts[-1]) == L_i:
            self._wire_qg, self._wire_qd = host_unpack_codes(compacts[-1], H, W, s)
        return ([np.pad(c, (0, L_i - len(c))) for c in compacts],
                [len(c) == L_i for c in compacts])

    def _start_copy(self, summary: torch.Tensor):
        """Begin a device->host copy into pinned memory; (host, event), the
        event None where nothing is in flight (CPU)."""
        if not summary.is_cuda:
            return summary, None
        host = torch.empty(summary.shape, dtype=summary.dtype, pin_memory=True)
        host.copy_(summary, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _landed(self, batch) -> bool:
        """Whether a staged batch is read now: once a later step call has
        been queued (a copy with no event, on the CPU, at once). The JAX
        package asks the copy's `is_ready`; a fixed lag of one step call
        keeps the drains pipelined and makes what the host reads, and so
        the trajectory, independent of how far it runs ahead (F11)."""
        return batch[2] is None or batch[3] < self._step_calls

    def _wait(self, event, lagged: bool = False) -> None:
        """Wait for a copy's event; a wait that finds it unfinished is
        counted in copy_waits, and a lagged one (a read outside a blocking
        drain) that ends with the newest queued step done in idle_waits."""
        if event is None or event.query():
            return
        self.copy_waits += 1
        with timing.span("drain.wait"):
            event.synchronize()
        if lagged and self._step_done is not None and self._step_done.query():
            self.idle_waits += 1

    def _starvation_alert(self, packed) -> bool:
        """Host early warning of an abrupt scene-contrast collapse (lights
        off, auto-exposure failure), from the wire's luma bytes: a >2.5x
        step of their spread against its running average. The fast path
        learns keypoint counts only at drains, so an alert makes the caller
        drain at once and the adaptive ladder see the starved count on the
        next frame. A collapse enters starved mode (drains synchronous until
        contrast recovers), a recovery clears it; the average re-bases on an
        alert, so a long dark stretch alerts once. ydct reads the DC plane's
        bytes (block means), yc12 the luma bytes."""
        if self.wire_delta or not isinstance(packed, np.ndarray):
            return False  # P wires carry residuals
        H, W = self.cam.height, self.cam.width
        if self.dct is not None:
            n = dct_wire.dc_len(H, W, self.dct)
        elif self.ingest_fmt == "yc12" and self.gray_bits in (5, 6):
            n = (H * W // 8) * 5 if self.gray_bits == 5 else (H * W // 4) * 3
        else:  # raw and 8-bit yc12: plain luma bytes
            n = H * W
        c = float(np.asarray(packed[:n:127], np.float32).std()) + 1e-3
        ema = self._contrast_ema
        if ema is None:
            self._contrast_ema = c
            return False
        alert = abs(float(np.log(c / ema))) > 0.916  # log(2.5)
        if alert:
            self._starved_mode = c < ema
            self._contrast_ema = c
        else:
            self._contrast_ema = 0.9 * ema + 0.1 * c
        return alert

    def _stage(self, pend):
        """Stack pending summaries on the device, start ONE asynchronous
        copy into pinned memory and mark it with an event."""
        host, event = self._start_copy(torch.stack([e[3] for e in pend]))
        return pend, host, event, self._step_calls

    def _drain_pending(self, keep_newest: int = 0) -> None:
        """Read pending step summaries into the host bookkeeping.

        keep_newest > 0 leaves the newest entries pending (their steps may
        still run). With tpu_drain_pipelined the drained entries are staged
        (_stage) and read one step call later (_landed), by
        _consume_ready_staged; at most 2 staged batches stay unread (the
        JAX package's bound for copies that never land), and a blocking
        drain (keep_newest=0) reads them all. While the adaptive ladder is
        engaged (threshold below its base), or in starved mode, drains are
        synchronous: the ladder needs every drain's counts."""
        lagged = keep_newest > 0
        self._consume_rescues(lagged)
        batches = []  # (pend, host rows or None, event[, staged at])
        if len(self._pending) > keep_newest:
            if keep_newest:
                pend, self._pending = self._pending[:-keep_newest], self._pending[-keep_newest:]
            else:
                pend, self._pending = self._pending, []
            uncopied = all(isinstance(e[3], torch.Tensor) for e in pend)
            if self.params["tpu_drain_pipelined"] and uncopied and not self._starved_mode:
                self._staged.append(self._stage(pend))
                while self._staged and (not keep_newest or len(self._staged) > 2
                                        or self._landed(self._staged[0])):
                    batches.append(self._staged.pop(0))
            else:
                # drains land in frame order: whatever is staged predates pend
                batches += self._staged
                self._staged = []
                batches.append((pend, None, None))
        elif keep_newest == 0:
            batches += self._staged
            self._staged = []
        fallbacks = []  # (new_id, fallback edge slot) for the ICP rescue
        for batch in batches:
            fallbacks += self._drain_batch(*batch[:3], lagged=lagged)
        while self._staged and self._ladder_engaged():
            # the ladder needs this drain's counts: read the batch just staged
            fallbacks += self._drain_batch(*self._staged.pop(0)[:3])
        if fallbacks and self.params["use_icp"]:
            self._dispatch_retro_rescue(fallbacks)

    def _consume_ready_staged(self) -> None:
        """Read the staged batches that _landed lets be read (JAX
        `_consume_ready_staged`), once a step call after their drain, so the
        ladder hears of starvation a group after the drain rather than a
        drain interval later."""
        fallbacks = []
        while self._staged and self._landed(self._staged[0]):
            fallbacks += self._drain_batch(*self._staged.pop(0)[:3], lagged=True)
        if fallbacks and self.params["use_icp"]:
            self._dispatch_retro_rescue(fallbacks)

    def _drain_batch(self, pend, host, event, lagged: bool = False) -> list:
        """Apply one batch of summaries to the host bookkeeping, in frame
        order. host/event: a staged copy, or None for entries that carry
        their own (a device row is read with one blocking copy); lagged as
        in _wait. Returns
        the (new_id, fallback edge slot) of the frames that fell back to a
        constant-position edge."""
        if host is None:
            on_device = [e[3] for e in pend if isinstance(e[3], torch.Tensor)]
            self.blocking_pulls += bool(on_device)
            with timing.span("drain.wait"):
                pulled = iter(torch.stack(on_device).cpu() if on_device else ())
            rows = []
            for e in pend:
                if isinstance(e[3], torch.Tensor):
                    rows.append(next(pulled))
                else:
                    row, ev = e[3]
                    self._wait(ev, lagged)
                    rows.append(row)
        else:
            self._wait(event, lagged)
            rows = host
        fallbacks = []
        with timing.span("drain.apply"):
            for (new_id, padded, edge_start, _), row in zip(pend, rows):
                s = StepSummary.unpack(row.numpy(), len(padded))
                fb = self.host.apply_summary(new_id, padded, edge_start, s)
                timing.end(self._landing.pop(new_id, None))
                if fb is not None:
                    fallbacks.append(fb)
                self._adapt_detector(s.n_valid_kp)
        return fallbacks

    def _dispatch_retro_rescue(self, fallbacks) -> None:
        """Queue the retroactive GICP rescue of a drain's constant-position
        fallback edges [(new_id, slot)] on the device, in chunks of
        tpu_drain_interval, each chained to the last rescue before it; the
        verdict flags start their copy to pinned memory at once and are
        read by _consume_rescues. No host read."""
        p = self.params
        cap = max(int(p["tpu_drain_interval"]), 1)
        for k0 in range(0, len(fallbacks), cap):
            chunk = fallbacks[k0 : k0 + cap]
            prev = self._last_rescue or (
                torch.eye(4, device=self.device), torch.zeros((), dtype=torch.bool,
                                                              device=self.device), 0)
            new_ids = [nid for nid, _ in chunk]
            slots = [slot for _, slot in chunk]
            flags, (last_T, last_ok) = retro_rescue(
                self.graph, self.store.depth, self.store.emm_lohi, new_ids, slots, prev,
                self.cam_small, int(p["icp_max_iterations"]), int(p["emm_skip_step"]),
                float(p["sigma_depth"]), str(p["icp_variant"]),
                float(p["observability_threshold"]))
            if len(chunk) < cap:
                # the JAX package pads a short chunk to cap rows, and a
                # padding row ends the chain: so does a short chunk here
                last_ok = torch.zeros_like(last_ok)
            self._last_rescue = (last_T, last_ok, chunk[-1][0])
            self.rescue_items += len(chunk)
            self._pending_rescues.append((new_ids, slots, *self._start_copy(flags)))

    def _consume_rescues(self, lagged: bool) -> None:
        """Fold the verdicts of the rescues dispatched since the last drain
        into the host mirrors (edge types, counters, reason="icp"
        decisions), in dispatch order, waiting for their copies (_wait,
        lagged as there): the card may still be on the rescue."""
        pend, self._pending_rescues = self._pending_rescues, []
        for new_ids, slots, host, event in pend:
            self._wait(event, lagged)
            flags = host.numpy()
            for k, (nid, slot) in enumerate(zip(new_ids, slots)):
                if flags[k, 0] > 0:
                    self.host.apply_rescue(slot)
                    self.n_icp_rescues += 1
                    self.last_decisions.append(MatchDecision(
                        cand_id=nid - 1, accepted=True, reason="icp",
                        n_inliers=int(flags[k, 1]), rmse=float(flags[k, 2]),
                        emm_quality=float(flags[k, 3])))

    def _ladder_engaged(self) -> bool:
        """Whether the adaptive FAST threshold sits below its base."""
        return (self._base_threshold is not None
                and self.extractor.fast_threshold < self._base_threshold)

    def _adapt_detector(self, n_valid_kp: int) -> None:
        """Halve the FAST threshold on starvation, step back on saturation
        (DetectorAdjuster semantics, at most adjuster_max_iterations rungs;
        nothing to adapt for SIFT)."""
        p = self.params
        max_rungs = p["adjuster_max_iterations"]
        if self._base_threshold is None or max_rungs <= 0:
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
    def _solver(self, n_cap: int) -> str:
        """backend_solver -> "dense" or "pcg" for a graph of n_cap nodes;
        counted in solver_calls."""
        name = {"cholesky": "dense", "dense": "dense", "pcg": "pcg"}.get(
            self.params["backend_solver"], "auto")
        solver = resolve_solver(name, n_cap)
        self.solver_calls[solver] += 1
        return solver

    def _apply_fixation(self) -> None:
        self.graph.node_fixed.copy_(self._to_device(self.host.fixation_mask(
            self.n_cap, self._nodes_opt_watermark, self.mapping_enabled)))

    def _optimize_inaffected(self, iterations: int, blocking: bool, pcg_iters: int,
                             read: bool = True) -> float:
        """Subgraph-only optimization (pose_relative_to=inaffected): the
        nodes added since the last optimize plus their fixed border,
        gathered, optimized and scattered back (graph_manager.cpp:889-892,
        969-992, 1031-1035)."""
        h = self.host
        sub = inaffected_subgraph(h.edge_i, h.edge_j, h.edge_active, self.n_edges,
                                  self._nodes_opt_watermark)
        if sub is None:
            return 0.0
        ncap, ecap = len(sub.gi), len(sub.ge)
        # one host->device copy: [gi | nfix | nact | free_mask | ge | li | lj | eact]
        buf = self._to_device(np.concatenate([
            sub.gi, sub.nfix, sub.nact, sub.free_mask, sub.ge, sub.li, sub.lj, sub.eact,
        ]).astype(np.int64))
        nodes = buf[: 4 * ncap].view(4, ncap)
        edges = buf[4 * ncap:].view(4, ecap)
        chi2, n_it = _inaffected_kernel(
            self.graph, nodes[0], edges[0], edges[1].to(torch.int32),
            edges[2].to(torch.int32), nodes[1].bool(), nodes[2].bool(), edges[3].bool(),
            nodes[3].bool(), iterations=iterations, huber_delta=self.params["huber_delta"],
            pcg_iters=pcg_iters, solver=self._solver(ncap), read_convergence=read)
        if blocking:
            return float(chi2)
        self.online_lm_iterations += n_it
        return float("nan")

    @torch.inference_mode()
    def optimize(self, iterations: Optional[int] = None, blocking: bool = True,
                 pcg_iters: Optional[int] = None) -> float:
        """LM pose-graph optimization over the committed nodes. The online
        call (blocking=False) drains all but the newest 2 summaries first,
        like the JAX package. The JAX loop stops on the device when it
        converges; here a stop needs the host to read the flag. The
        host-decision path waits for the card every frame anyway, so its
        online call reads the flag after each LM iteration and stops early;
        on the keep-all fast path, whose frames never wait, the online call
        runs all its iterations with those after convergence masked (the
        same poses) and reads nothing."""
        with timing.span("optimize.blocking" if blocking else "optimize.online"):
            if not blocking:
                self.online_optimizes += 1
            self._drain_pending(keep_newest=0 if blocking else 2)
            p = self.params
            read = blocking or not (self.mapping_enabled and fast_path(p))
            try:
                if (p["pose_relative_to"] == "inaffected" and self.mapping_enabled
                        and 1 < self._nodes_opt_watermark < self.n_nodes):
                    return self._optimize_inaffected(
                        iterations or p["optimizer_iterations"], blocking,
                        pcg_iters if pcg_iters is not None else 24, read)
                solver = self._solver(self.n_cap)
                self._apply_fixation()
                chi2, n_it = optimize(
                    self.graph, iterations=iterations or p["optimizer_iterations"],
                    huber_delta=p["huber_delta"],
                    pcg_iters=pcg_iters if pcg_iters is not None else 64, solver=solver,
                    n_nodes=self.n_nodes, n_edges=self.n_edges, read_convergence=read)
                if blocking:
                    # the JAX package reports iterations of blocking calls only
                    self.last_optimize_iters = int(n_it)
                    return float(chi2)
                self.online_lm_iterations += n_it
                return float("nan")
            finally:
                self.nodes_since_optimize = 0
                # the reference's rule (rgbdslam_v2_tpu/graph/manager.py, the end
                # of GraphManager.optimize): the watermark stops at the oldest
                # still-pending node. Batches a pipelined drain left staged and
                # unread are not counted, so their nodes stay fixed in later
                # inaffected optimizes; kept for parity, and a fix belongs in
                # both packages at once (ROADMAP F10)
                pending = [e[0] for e in self._pending]
                self._nodes_opt_watermark = min(pending) if pending else self.n_nodes

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

    # ---- landmark BA and empirical covariances ----------------------------
    def _rematch(self, pairs) -> tuple:
        """Each (i, j) node pair's descriptors matched again (the port's
        batched match_descriptors at m_cap 128 and nn_distance_ratio), in
        chunks of pairs whose distance matrices fit PAIR_CHUNK_BYTES; host
        (P, 128) arrays (src_idx, dst_idx, valid)."""
        s = self.store
        ii = torch.tensor([i for i, _ in pairs], dtype=torch.long, device=self.device)
        jj = torch.tensor([j for _, j in pairs], dtype=torch.long, device=self.device)
        chunk = max(1, PAIR_CHUNK_BYTES // (4 * self.k_cap * self.k_cap))
        out = []
        for c0 in range(0, len(pairs), chunk):
            a, b = ii[c0:c0 + chunk], jj[c0:c0 + chunk]
            m = match_descriptors(s.desc[a], s.kp_valid[a], s.desc[b], s.kp_valid[b], 128,
                                  self.params["nn_distance_ratio"])
            out.append(torch.stack([m.src_idx, m.dst_idx, m.valid.long()]))
        host = torch.cat(out, dim=1).cpu().numpy()
        return host[0], host[1], host[2].astype(bool)

    @torch.inference_mode()
    def optimize_landmarks(self, iterations: int = 8, min_obs: int = 2,
                           max_landmarks: int = 8192, max_obs: int = 32768,
                           merge_dist: float = 0.10) -> dict:
        """Landmark bundle adjustment (the reference's DO_FEATURE_OPTIMIZATION:
        features as landmarks observed by EdgeSE3PointXYZDepth edges;
        src/landmark.cpp, graph_manager.cpp:137-143,188-200). Feature
        tracks come from matching the descriptors of every active visual
        edge's nodes again, joined into landmarks by union-find over (node,
        keypoint) observations with a world-distance gate (host code, as in
        the JAX package); then the poses and landmarks are refined by
        alternating Gauss-Newton (optim/landmark_ba.py) and the poses are
        written back to the graph. Returns landmarks, observations and the
        chi2 before and after."""
        from ..optim.landmark_ba import LandmarkGraph, chi2 as lm_chi2
        from ..optim.landmark_ba import optimize_landmarks as opt_lm

        self._drain_pending()
        h = self.host
        pairs = [h.edge_pairs[e] for e in range(self.n_edges)
                 if h.edge_active[e] and h.edge_types[e] in (EDGE_SEQUENTIAL, EDGE_LOOP)]
        if not pairs:
            return {"landmarks": 0, "observations": 0}
        src, dst, ok = self._rematch(pairs)
        n = self.n_nodes
        uv = self.store.uv[:n].cpu().numpy()
        xyz = self.store.xyz[:n].cpu().numpy()
        poses = self.poses()

        parent = {}  # union-find over (node, keypoint) observation keys

        def find(x):
            root = x
            while parent.get(root, root) != root:
                root = parent[root]
            while parent.get(x, x) != x:
                parent[x], x = root, parent[x]
            return root

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        for p_idx, (i, j) in enumerate(pairs):
            si, dj = src[p_idx], dst[p_idx]
            # the world-consistency gate under the current pose estimates
            wi = (poses[i, :3, :3] @ xyz[i, si].T).T + poses[i, :3, 3]
            wj = (poses[j, :3, :3] @ xyz[j, dj].T).T + poses[j, :3, 3]
            good = ok[p_idx] & (np.linalg.norm(wi - wj, axis=-1) < merge_dist)
            for a, b in zip(si[good], dj[good]):
                union((i, int(a)), (j, int(b)))

        tracks = {}
        for key in list(parent.keys()) + list(parent.values()):
            tracks.setdefault(find(key), []).append(key)
        tracks = {r: sorted(set(obs)) for r, obs in tracks.items()
                  if len({nid for nid, _ in obs}) >= min_obs}
        track_list = sorted(tracks.values(), key=len, reverse=True)[:max_landmarks]
        obs_lm, obs_pose, obs_uvz, lm_init = [], [], [], []
        for obs in track_list:
            per_node = {}
            for nid, k in obs:
                per_node.setdefault(nid, k)  # one observation a node
            if len(obs_lm) + len(per_node) > max_obs:
                break
            lid = len(lm_init)
            pts = []
            for nid, k in per_node.items():
                obs_lm.append(lid)
                obs_pose.append(nid)
                obs_uvz.append([uv[nid, k, 0], uv[nid, k, 1], xyz[nid, k, 2]])
                pts.append(poses[nid, :3, :3] @ xyz[nid, k] + poses[nid, :3, 3])
            lm_init.append(np.mean(pts, axis=0))
        if not lm_init:
            return {"landmarks": 0, "observations": 0}
        L, O = len(lm_init), len(obs_lm)
        # capacities rounded up to powers of two, as the JAX package rounds
        # them (its compiled shapes)
        ncap = max(32, 1 << (n - 1).bit_length())
        lcap = max(64, 1 << (L - 1).bit_length())
        ocap = max(128, 1 << (O - 1).bit_length())

        def dev(a, dtype=None):
            return self._to_device(np.asarray(a, dtype))

        g = LandmarkGraph(
            poses=dev(np.concatenate([poses, np.broadcast_to(np.eye(4, dtype=np.float32),
                                                             (ncap - n, 4, 4))])),
            pose_fixed=dev([True] + [False] * (n - 1) + [True] * (ncap - n), bool),
            landmarks=dev(np.concatenate([np.asarray(lm_init, np.float32),
                                          np.zeros((lcap - L, 3), np.float32)])),
            lm_active=dev([True] * L + [False] * (lcap - L), bool),
            obs_lm=dev(obs_lm + [0] * (ocap - O), np.int64),
            obs_pose=dev(obs_pose + [0] * (ocap - O), np.int64),
            obs_uvz=dev(np.concatenate([np.asarray(obs_uvz, np.float32),
                                        np.zeros((ocap - O, 3), np.float32)])),
            obs_active=dev([True] * O + [False] * (ocap - O), bool))
        sigma = self.params["sigma_depth"]
        before = float(lm_chi2(g, self.cam, sigma))
        g = opt_lm(g, self.cam, iterations=iterations, sigma_depth=sigma)
        after = float(lm_chi2(g, self.cam, sigma))
        self.graph.poses[:n] = g.poses[:n]
        return {"landmarks": L, "observations": O, "chi2_before": before, "chi2_after": after}

    @torch.inference_mode()
    def set_empirical_covariances(self, bandwidth: float = 0.1) -> None:
        """setEmpiricalCovariances (graph_manager2.cpp:111-144): the edges'
        information re-derived from residual statistics
        (optim/covariance.py); inactive slots keep theirs."""
        from ..optim.covariance import empirical_information

        self._drain_pending()
        self.graph.edge_info.copy_(empirical_information(self.graph, bandwidth=bandwidth,
                                                         n_edges=self.n_edges))

    # ------------------------------------------------------------------
    def poses(self) -> np.ndarray:
        """A host copy of the committed nodes' poses (never a view of the
        graph, which later optimizes write in place)."""
        return self.graph.poses[: self.n_nodes].cpu().numpy().copy()

    def trajectory(self):
        return list(self.timestamps), self.poses()

    def reset(self) -> None:
        """A fresh graph with the same camera, parameters, device and
        (possibly adapted) extractor."""
        self.__init__(self.cam, self.params, self.device, self.extractor)

    def toggle_mapping(self, enabled: bool) -> None:
        """Localization-only mode (graph_manager2.cpp:25-35): with mapping
        off every node is fixed and frames only localize."""
        self.mapping_enabled = enabled
        if not enabled:
            mask = np.zeros(self.n_cap, bool)
            mask[: self.n_nodes] = True
            self.graph.node_fixed.copy_(self._to_device(mask))
            self._drain_pending()
            self._loc_poses_host = self.poses()  # one pull; poses now frozen
        else:
            self._loc_poses_host = None

    def delete_last_frame(self) -> None:
        """deleteLastFrame (graph_manager2.cpp:61): remove the newest node
        and its edges from the active graph."""
        self._drain_pending()
        if self.n_nodes <= 1:
            return
        nid = self.host.delete_last()
        self.graph.edge_active.copy_(self._to_device(self.host.edge_active))
        self.graph.node_active[nid].fill_(False)
        self.store.clear_features(nid)

    def clear_feature_information(self, node_id: int) -> None:
        """clearFeatureInformation (node.cpp:1431): free a node's feature
        slots."""
        self.store.clear_features(int(node_id))

    def sanity_check(self) -> List[str]:
        """sanityCheck (graph_manager.cpp:1347): problems found, if any."""
        self._drain_pending()
        problems = []
        poses = self.poses()
        if not np.isfinite(poses).all():
            problems.append("non-finite pose entries")
        R = poses[:, :3, :3]
        orth = np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() if len(R) else 0.0
        if orth > 1e-2:
            problems.append(f"non-orthonormal rotations (max dev {orth:.2e})")
        active = self.graph.edge_active.cpu().numpy()
        for e in range(self.n_edges):
            pair = self.host.edge_pairs[e]
            if active[e] and pair is not None and max(pair) >= self.n_nodes:
                problems.append(f"edge {e} references inactive node")
        return problems

    def memory_footprint(self) -> dict:
        """getMemoryFootprint (node.cpp:1461): bytes of the node store and of
        the graph on the device."""
        self._drain_pending()

        def nbytes(state):
            return sum(t.numel() * t.element_size()
                       for t in (getattr(state, f.name) for f in dataclasses.fields(state)))

        return {"node_store_bytes": nbytes(self.store), "graph_bytes": nbytes(self.graph),
                "nodes": self.n_nodes}

    def save_state(self, path) -> None:
        """Checkpoint the SLAM state into an .npz (a capability beyond the
        reference, which has none): the JAX package's __meta__ keys, the
        store and graph arrays by field name, and the port's run state."""
        from ..interop import to_numpy

        self._drain_pending()
        h = self.host
        arrays = {f"store_{k}": v for k, v in to_numpy(self.store).items()}
        arrays.update({f"graph_{k}": v for k, v in to_numpy(self.graph).items()})
        arrays["generator_state"] = self.generator.get_state().numpy()
        if self._last_rescue is not None:
            arrays["last_rescue_T"] = self._last_rescue[0].cpu().numpy()
            arrays["last_rescue_ok"] = self._last_rescue[1].cpu().numpy()
        meta = dict(
            n_nodes=h.n_nodes, n_edges=h.n_edges, n_loop_edges=h.n_loop_edges,
            n_seq_edges=h.n_seq_edges, timestamps=list(h.timestamps),
            keyframes=list(h.keyframes), edge_types=list(h.edge_types),
            edge_pairs=[None if q is None else list(q) for q in h.edge_pairs],
            adjacency={str(k): sorted(v) for k, v in h.adjacency.items()},
            edge_active_host=[int(x) for x in h.edge_active[: h.n_edges]],
            nodes_opt_watermark=self._nodes_opt_watermark, kp_count0=self._kp_count0,
            port=dict(
                fast_threshold=getattr(self.extractor, "fast_threshold", None),
                contrast_ema=self._contrast_ema, starved_mode=self._starved_mode,
                nodes_since_optimize=self.nodes_since_optimize,
                clear_queue=list(h.clear_queue), host_rng=h.rng.bit_generator.state,
                first_pose=np.asarray(self._first_pose, np.float64).tolist(),
                mapping_enabled=self.mapping_enabled, n_icp_rescues=self.n_icp_rescues,
                rescue_items=self.rescue_items,
                last_rescue_node=None if self._last_rescue is None else self._last_rescue[2],
            ),
        )
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)

    def load_state(self, path) -> None:
        """Restore a checkpoint of save_state, or one the JAX package saved
        (numbered leaves: interop.jax_checkpoint_arrays), into this
        manager's tensors in place; the capacities must be equal. A JAX
        checkpoint carries no run state: the extractor, RNGs and trackers
        stay as they are."""
        from ..interop import graph_from_numpy, jax_checkpoint_arrays, store_from_numpy

        self._drain_pending()
        self._pending, self._staged, self._pending_rescues = [], [], []
        self._retrieval = None
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            if "store_0" in data.files:
                store, graph = jax_checkpoint_arrays(data)
            else:
                store = {f.name: data[f"store_{f.name}"] for f in dataclasses.fields(NodeStore)}
                graph = {f.name: data[f"graph_{f.name}"] for f in dataclasses.fields(GraphState)}
            extra = {k: data[k] for k in ("generator_state", "last_rescue_T", "last_rescue_ok")
                     if k in data.files}
        for state, loaded in ((self.store, store_from_numpy(store)),
                              (self.graph, graph_from_numpy(graph))):
            for f in dataclasses.fields(state):
                dst, src = getattr(state, f.name), getattr(loaded, f.name)
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(f"checkpoint {f.name} is {tuple(src.shape)} {src.dtype}, "
                                     f"this manager holds {tuple(dst.shape)} {dst.dtype}")
                dst.copy_(src)
        h = self.host
        h.n_nodes, h.n_edges = meta["n_nodes"], meta["n_edges"]
        h.n_loop_edges, h.n_seq_edges = meta["n_loop_edges"], meta["n_seq_edges"]
        h.timestamps = list(meta["timestamps"])
        h.keyframes = list(meta["keyframes"])
        h.edge_types = list(meta["edge_types"])
        h.edge_pairs = [None if q is None else tuple(q) for q in meta["edge_pairs"]]
        h.adjacency = {int(k): set(v) for k, v in meta["adjacency"].items()}
        h.edge_active[:] = False
        h.edge_active[: h.n_edges] = np.asarray(meta["edge_active_host"], bool)
        h.edge_i[:], h.edge_j[:] = -1, -1
        for e, pair in enumerate(h.edge_pairs):
            if pair is not None:
                h.edge_i[e], h.edge_j[e] = pair
        self._nodes_opt_watermark = meta["nodes_opt_watermark"]
        self._kp_count0 = meta["kp_count0"]
        self._loc_poses_host = None
        # a continued run starts at another frame than the saved wire codes'
        # successor: the next fast-path frame ships an I wire
        self._wire_synced = False
        run = meta.get("port")
        if run is None:
            return
        if self._base_threshold is not None:
            self.extractor = dataclasses.replace(self.extractor,
                                                 fast_threshold=run["fast_threshold"])
        self._contrast_ema, self._starved_mode = run["contrast_ema"], run["starved_mode"]
        self.nodes_since_optimize = run["nodes_since_optimize"]
        h.clear_queue = list(run["clear_queue"])
        h.rng.bit_generator.state = run["host_rng"]
        self._first_pose = np.asarray(run["first_pose"], np.float32)
        self.mapping_enabled = run["mapping_enabled"]
        self.n_icp_rescues, self.rescue_items = run["n_icp_rescues"], run["rescue_items"]
        state = torch.from_numpy(extra["generator_state"])
        if state.numel() == self.generator.get_state().numel():
            self.generator.set_state(state)
        else:  # saved on another device type: its RNG state does not fit here
            logger.warning("checkpoint RNG state is of another device; RANSAC draws "
                           "go on from this manager's generator")
        self._last_rescue = None
        if run["last_rescue_node"] is not None:
            self._last_rescue = (torch.from_numpy(extra["last_rescue_T"]).to(self.device),
                                 torch.from_numpy(extra["last_rescue_ok"]).to(self.device),
                                 run["last_rescue_node"])

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
            "icp_rescues": self.n_icp_rescues,
        }
