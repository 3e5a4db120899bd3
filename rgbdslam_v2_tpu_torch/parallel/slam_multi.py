"""Full SLAM over many sequences at once: S sequences advance in lockstep,
each with its complete system.

Port of ``rgbdslam_v2_tpu/parallel/slam_multi.py::MultiSequenceSlam``.
The reference evaluates its benchmark sequences one full run after
another (test/run_tests.sh:21-76: features, candidate matching, EMM, the
pose graph and the 5-level protocol for every bag). Here S such runs share
the device: a lockstep frame runs the keep-all device step
(graph/device_step.slam_step) of every sequence, and the pose-graph
optimization and the 5-level protocol (openni_listener.cpp:431-518) run
per sequence on its own graph.

* Device state: each mesh device holds its sequences' node stores and
  graphs as stacked tensors with a leading sequence axis; sequence i's
  NodeStore and GraphState are views [i] of them, which every step writes
  in place, so the trajectories of all sequences are one read.
* The step: on the card, the S_local sequences' step bodies on one device
  are captured into ONE CUDA graph (every sequence's generator registered
  with it), so a lockstep frame is one host-to-device copy of the packed
  inputs and one replay a device: the counterpart of the JAX package's one
  vmapped program. As device_step.StepGraph does, the first lockstep frame
  of a key (every sequence's FAST threshold and the wire) runs eagerly on
  a side stream, the second is captured, and a failed capture raises.
* Host side: sequence i is a graph.manager.GraphManager over those views
  (``_SeqManager``), seeded as GraphManager seeds its own with tpu_seed =
  seed0 + i. Candidate selection, drains (a staged drain is read one step
  call later, F11), the adaptive detector, the starvation alert and the
  online optimize are its code, so sequence i reproduces a single manager
  fed the same wires with add_frame: the same slots, decisions and edges.
  The summaries of all sequences on a device, (S_local, 4B+2), reach the
  host in one asynchronous copy a lockstep frame; each sequence's drains
  read its rows of those copies.
* Mesh: the sequences split into contiguous blocks over its devices, as
  P("c") does; the result equals mesh=None.

Scope: the keep-all device step, whatever keep_all_nodes and the motion
gates say, as in the JAX package (the setting of the reference's benchmark
harness, test/test_settings.launch:26-114). UNSUPPORTED lists the
single-sequence features; requesting one warns and sets it to its neutral
value.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import backend
from ..config import ParameterServer, default_params
from ..core.camera import Intrinsics
from ..graph.device_step import CapturedSteps, group_views, slam_stepN, step_key
from ..graph.host_graph import HostGraph
from ..graph.manager import GraphManager, descriptor_layout, make_extractor
from ..graph.node_store import NodeStore
from ..optim.pose_graph import GraphState, make_graph_state
from .mesh import DeviceMesh, on_device

logger = logging.getLogger("rgbdslam.parallel")


def _stacked(state, m: int):
    """A NodeStore / GraphState of m * cap rows viewed as m stacked ones."""
    return type(state)(*(t.view(m, t.shape[0] // m, *t.shape[1:])
                         for t in (getattr(state, f.name) for f in dataclasses.fields(state))))


def _row(stack, k: int):
    """Sequence k's NodeStore / GraphState: views [k] of a stack."""
    return type(stack)(*(getattr(stack, f.name)[k] for f in dataclasses.fields(stack)))


def _nbytes(state) -> int:
    return sum(t.numel() * t.element_size()
               for t in (getattr(state, f.name) for f in dataclasses.fields(state)))


class _SeqManager(GraphManager):
    """One sequence: a GraphManager over views of the stacks, whose steps
    the lockstep frame runs. Its summary rows are rows of the per-frame
    copy of every sequence's summaries, already on their way to the host,
    so a drain stages them without a copy of its own."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._row_events: Dict[int, object] = {}  # node id -> its frame's copy event

    def _stage(self, pend):
        # copies complete in order: the newest row's event covers the batch
        return pend, [e[3] for e in pend], self._row_events[pend[-1][0]], self._step_calls

    def _drain_batch(self, pend, host, event, lagged: bool = False) -> list:
        if host is None:  # read at once: wait for the newest row's copy
            self.blocking_pulls += 1
            ev = self._row_events[pend[-1][0]]
            if ev is not None:
                ev.synchronize()
            host = [e[3] for e in pend]
        for e in pend:
            self._row_events.pop(e[0], None)
        return GraphManager._drain_batch(self, pend, host, event, lagged)


class _Shard:
    """One mesh device's sequences: the stacks, the sequences' managers
    and, on the card, the lockstep step's CUDA graphs."""

    def __init__(self, device: torch.device, seqs: List[_SeqManager], store: NodeStore,
                 graph: GraphState):
        self.device, self.seqs, self.store, self.graph = device, seqs, store, graph
        self.steps = (CapturedSteps(device, [sq.generator for sq in seqs])
                      if device.type == "cuda" else None)


class MultiSequenceSlam:
    """S full-SLAM instances whose frames advance in lockstep, their device
    state stacked (and optionally sharded over a mesh)."""

    # Single-sequence-only features (PARITY.md section 2.3): requesting one
    # here warns and sets its neutral value. (name, is_requested, neutral)
    UNSUPPORTED = (
        ("global_loop_candidates", lambda v: v > 0, 0),  # appearance retrieval
        ("use_robot_odom", bool, False),
        ("use_robot_odom_only", bool, False),
        ("tpu_wire_delta", bool, False),  # serial host-loop wire optimization
        # incremental 'inaffected' fixation needs per-sequence affected-set
        # tracking; the optimize here fixes the first node
        ("pose_relative_to", lambda v: v == "inaffected", "first"),
    )

    def __init__(self, cam: Intrinsics, n_sequences: int,
                 params: Optional[ParameterServer] = None, mesh: Optional[DeviceMesh] = None,
                 extractor=None, device=None):
        """mesh: the devices the sequences shard over (S must divide by its
        size); without one every sequence runs on `device`, the CUDA card
        unless the CPU is asked for."""
        self.params = p = params or default_params()
        for name, requested, neutral in self.UNSUPPORTED:
            if requested(p[name]):
                logger.warning("MultiSequenceSlam does not support %s (single-sequence path "
                               "only; PARITY.md section 2.3); forcing %r", name, neutral)
                p.set(name, neutral)
        self.cam = cam
        self.S = S = int(n_sequences)
        self.mesh = mesh
        devices = mesh.devices if mesh is not None else (backend.resolve_device(device),)
        if S % len(devices):
            raise ValueError(f"{S} sequences not divisible by {len(devices)} devices")
        self.n_cap = n_cap = p["tpu_max_nodes"]
        self.e_cap = e_cap = p["tpu_max_edges"]
        self.cand_batch = p["tpu_candidate_batch"]
        s = p["cloud_creation_skip_step"]
        h, w = cam.height // s, cam.width // s
        extractor = extractor or make_extractor(p, p["max_keypoints"])
        desc_dim, desc_dtype = descriptor_layout(extractor, p)
        seed0 = int(p["tpu_seed"])
        self.seq: List[_SeqManager] = []
        self.shards: List[_Shard] = []
        m = S // len(devices)
        for dev in devices:
            dev = backend.resolve_device(dev)
            store = _stacked(NodeStore.create(
                m * n_cap, p["max_keypoints"], desc_dim, h, w, store_color=p["store_pointclouds"],
                device=dev, desc_dtype=desc_dtype), m)
            graph = _stacked(make_graph_state(m * n_cap, m * e_cap, device=dev), m)
            seqs = []
            for k in range(m):
                sq = _SeqManager(cam, p, dev, extractor, state=(_row(store, k), _row(graph, k)))
                i = len(self.seq)
                # seeded as GraphManager seeds its own with tpu_seed = seed0 + i
                sq.host = HostGraph(e_cap, p, seed0 + i)
                sq.generator.manual_seed(seed0 + i)
                seqs.append(sq)
                self.seq.append(sq)
            self.shards.append(_Shard(dev, seqs, store, graph))

    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self.seq[0].n_nodes

    def state_bytes(self) -> int:
        """Bytes of the stacked stores and graphs on the devices."""
        return sum(_nbytes(sh.store) + _nbytes(sh.graph) for sh in self.shards)

    def compact(self, rgb, depth) -> np.ndarray:
        """One frame's wire, as GraphManager.encode makes it."""
        return self.seq[0].encode(rgb, depth)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def add_frames(self, compacts, timestamps, gt_poses=None) -> None:
        """One lockstep frame for all S sequences.

        compacts: (S, n_bytes) uint8 (stacked wires of compact);
        timestamps: (S,) or a scalar; gt_poses: optional (S, 4, 4), read
        for the first frame only (firstNode's ground-truth anchor)."""
        compacts = np.ascontiguousarray(np.atleast_2d(np.asarray(compacts)))
        if compacts.shape[0] != self.S:
            raise ValueError(f"{compacts.shape[0]} wires for {self.S} sequences")
        ts = np.broadcast_to(np.asarray(timestamps, np.float64).reshape(-1), (self.S,))
        if self.n_nodes == 0:
            for i, sq in enumerate(self.seq):
                with on_device(sq.device):
                    sq._add_first_frame(sq._to_device(compacts[i]), float(ts[i]),
                                        None if gt_poses is None else np.asarray(gt_poses[i]))
            return
        new_id = self.n_nodes
        B = self.cand_batch
        if new_id >= self.n_cap:
            raise RuntimeError("node capacity exceeded")
        if any(sq.n_edges + B + 1 > self.e_cap for sq in self.seq):
            raise RuntimeError("edge capacity exceeded")
        i = 0
        for sh in self.shards:
            with on_device(sh.device):
                self._lockstep_shard(sh, compacts[i:i + len(sh.seqs)], ts[i:i + len(sh.seqs)],
                                     new_id)
            i += len(sh.seqs)

    def _lockstep_shard(self, sh: _Shard, compacts, ts, new_id: int) -> None:
        """One lockstep frame of one device's sequences: their slots, one
        packed input buffer, the step (a graph replay on the card), one
        copy of their summaries to the host, then each sequence's
        bookkeeping."""
        B = self.cand_batch
        inputs = [sq._frame_inputs([compacts[k]], [float(ts[k])], [new_id], pin=False)
                  for k, sq in enumerate(sh.seqs)]
        L = inputs[0][4]
        cfgs = [sq._step_cfg() for sq in sh.seqs]
        cuda = sh.device.type == "cuda"
        # one row a sequence, its length rounded up to 8 bytes: the views of
        # each row's long block stay aligned
        size = inputs[0][1].numel()
        flat = torch.zeros((len(sh.seqs), -(-size // 8) * 8), dtype=torch.uint8, pin_memory=cuda)
        for k, x in enumerate(inputs):
            flat[k, :size].copy_(x[1])

        def body(dflat):
            return torch.cat([
                slam_stepN(sq.store, sq.graph, group_views(dflat[k, :size], 1, L, B),
                           sq.generator, None, **cfg)
                for k, (sq, cfg) in enumerate(zip(sh.seqs, cfgs))])

        if sh.steps is not None:
            sums = sh.steps.launch(tuple(step_key(1, L, cfg, None) for cfg in cfgs), flat, body)
        else:  # the CPU, or eager steps on the card
            sums = body(flat.to(sh.device, non_blocking=True))
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        host, event = sh.seqs[0]._start_copy(sums)  # one copy for the shard's sequences
        for k, sq in enumerate(sh.seqs):
            sq._step_calls += 1
            sq._step_done = done
            sq._row_events[new_id] = event
            cpt, _, slots, e_starts, _ = inputs[k]
            sq._frames_queued(cpt, [float(ts[k])], [new_id], slots, e_starts, [host[k]])

    # ------------------------------------------------------------------
    def _drain(self, keep_newest: int = 0) -> None:
        """Every sequence's pending summaries into its host bookkeeping
        (GraphManager._drain_pending)."""
        for sq in self.seq:
            sq._drain_pending(keep_newest=keep_newest)

    def optimize(self, iterations: Optional[int] = None, blocking: bool = True,
                 pcg_iters: int = 64) -> np.ndarray:
        """Each sequence's pose-graph optimize (GraphManager.optimize over
        its committed prefix, pose_relative_to's fixation: the first node
        unless configured otherwise). Returns the per-sequence chi2 (NaN
        where non-blocking)."""
        return np.asarray([sq.optimize(iterations=iterations, blocking=blocking,
                                       pcg_iters=pcg_iters) for sq in self.seq])

    def prune_edges_above(self, threshold: float) -> np.ndarray:
        """Per-sequence pruneEdgesWithErrorAbove (graph_manager.cpp:1106):
        edges above chi2 threshold deactivated, a pruned consecutive-node
        edge replaced by a weak constant-position edge. Returns the counts."""
        return np.asarray([sq.prune_edges_above(threshold) for sq in self.seq], np.int64)

    def trajectories(self) -> np.ndarray:
        """(S, n_nodes, 4, 4) world_T_cam: one read a device."""
        n = self.n_nodes
        return np.concatenate([sh.graph.poses[:, :n].cpu().numpy() for sh in self.shards])

    def statistics(self) -> List[dict]:
        self._drain()
        keys = ("nodes", "edges", "active_edges", "loop_edges", "sequential_edges", "keyframes")
        return [{k: st[k] for k in keys} for st in (sq.statistics() for sq in self.seq)]

    # ------------------------------------------------------------------
    def evaluation_protocol(self, gt_stamps=None, gt_xyz=None):
        """The reference's 5-level protocol, per sequence: L0 online poses;
        L1 full optimize; L2..L4 prune chi2 > {edge_error_threshold, 1,
        0.25} and re-optimize (openni_listener.cpp:431-518), the first node
        fixed as SlamPipeline.evaluation_protocol fixes it. Returns
        {level: (S, T, 4, 4) poses} and, with ground truth (per-sequence
        lists gt_stamps, gt_xyz), {level: (S,) ATE rmse}."""
        from ..eval.ate import evaluate_ate

        p = self.params
        levels: Dict[int, np.ndarray] = {0: self.trajectories()}
        saved = p["pose_relative_to"]
        try:
            p.set("pose_relative_to", "first")
            self.optimize(iterations=p["optimizer_iterations"] * 2)
            levels[1] = self.trajectories()
            for level, thresh in ((2, p["edge_error_threshold"]), (3, 1.0), (4, 0.25)):
                self.prune_edges_above(thresh)
                self.optimize(iterations=p["optimizer_iterations"])
                levels[level] = self.trajectories()
        finally:
            p.set("pose_relative_to", saved)
        ate: Dict[int, np.ndarray] = {}
        if gt_stamps is not None and gt_xyz is not None:
            for level, poses in levels.items():
                rmse = np.full(self.S, np.nan)
                for i, sq in enumerate(self.seq):
                    try:
                        rmse[i] = evaluate_ate(sq.timestamps, poses[i, :, :3, 3],
                                               gt_stamps[i], gt_xyz[i]).rmse
                    except ValueError:
                        pass
                ate[level] = rmse
        return levels, ate
