"""The per-frame keep-all step: extract, compare, decide, commit; and the
N-frame step, replayed on the card as one CUDA graph.

Port of ``rgbdslam_v2_tpu/graph/device_step.py`` (``_compute_body`` and
``_commit_body``, ``StepSummary``, ``make_slam_stepN``). The JAX package
splits compute and commit into two programs only to steer XLA's copy
insertion; here they are one function that writes the node row and its
B+1 edge slots in place. All per-frame decisions stay on the device; the
host reads the packed (4B+2,) summary later, at a drain.

Node ids, the predecessor id and the first edge slot are (1,) long device
tensors, and every write indexes with them (``index_copy_``), so the
step's kernels do not depend on the frame: :class:`StepGraph` captures
``slam_stepN`` once per (n, FAST threshold, wire length, step options) and
replays it for every later group, with the group's inputs copied into
static buffers first. Under the delta wire (``tpu_wire_delta``) every wire
is padded to the I length and carries an I/P flag read on the device, and
the previous frame's wire codes live in two device tensors that each step
reads and overwrites, so one graph serves every I/P pattern. With
``edge_info_mode="hessian"`` the visual edges carry the GN pose
information, trace-matched to the scalar magnitude (JAX
``_compute_body``'s hessian branch). The capture needs a step without
host syncs: the RANSAC refits, the projective stage and the final score
run in one kernel launch (``csrc/kabsch.cu``'s ``ransac_refine_f32``), not
through cuSOLVER.

``commit_node`` is the in-place write shared with the host-decision path
(JAX ``manager._commit_node``).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core import alignment
from ..ops import detect, registration
from ..optim.pose_graph import GraphState
from .compare import compare_to_candidates
from .ingest import prepare_and_extract, prepare_and_extract_wire
from .node_store import NodeStore


class StepSummary(NamedTuple):
    """Per-frame outputs for host bookkeeping, unpacked from the flat
    (4B+2,) float32 vector the step returns."""

    accepted: np.ndarray  # (B,) bool
    n_inliers: np.ndarray  # (B,) int
    rmse: np.ndarray
    emm_quality: np.ndarray
    fallback_used: bool
    n_valid_kp: int

    @classmethod
    def unpack(cls, flat: np.ndarray, B: int) -> "StepSummary":
        return cls(
            accepted=flat[:B] > 0.5,
            n_inliers=flat[B : 2 * B].astype(int),
            rmse=flat[2 * B : 3 * B],
            emm_quality=flat[3 * B : 4 * B],
            fallback_used=bool(flat[4 * B] > 0.5),
            n_valid_kp=int(flat[4 * B + 1]),
        )


def commit_node(store: NodeStore, graph: GraphState, new_id: torch.Tensor, kp, depth_small,
                color_small, base_id: torch.Tensor, base_T_new: torch.Tensor,
                edge_start: torch.Tensor, e_i: torch.Tensor, e_j: torch.Tensor,
                e_meas: torch.Tensor, e_info: torch.Tensor, e_active: torch.Tensor) -> None:
    """Insert node new_id, posed at poses[base_id] @ base_T_new, and write
    the edge slots edge_start.. where e_active, in place. new_id, base_id and
    edge_start are (1,) long device tensors; e_i, e_j (n,) int32."""
    store.insert(new_id, kp, depth_small, color_small)
    pose = graph.poses.index_select(0, base_id)[0] @ base_T_new
    graph.poses.index_copy_(0, new_id, pose[None])
    graph.node_active.index_fill_(0, new_id, True)
    slots = edge_start + torch.arange(e_i.shape[0], device=edge_start.device)

    def write(t, new, mask):
        t.index_copy_(0, slots, torch.where(mask, new, t.index_select(0, slots)))

    write(graph.edge_i, e_i, e_active)
    write(graph.edge_j, e_j, e_active)
    write(graph.edge_meas, e_meas, e_active[:, None, None])
    write(graph.edge_info, e_info, e_active[:, None, None])
    graph.edge_active.index_copy_(0, slots, graph.edge_active.index_select(0, slots) | e_active)


def slam_step(
    store: NodeStore,
    graph: GraphState,
    packed: torch.Tensor,  # (L,) u8 yc12/ydct buffer on the device
    new_id: torch.Tensor,  # (1,) long
    pred_id: torch.Tensor,  # (1,) long
    cand_idx: torch.Tensor,  # (B,) long
    cand_dup: torch.Tensor,  # (B,) bool, padding duplicates
    cand_dt: torch.Tensor,  # (B,) float32 |t_new - t_cand|
    edge_start: torch.Tensor,  # (1,) long
    generator: torch.Generator,
    intra: torch.Tensor = None,  # () u8, nonzero for an I wire (delta wire only)
    wire=None,  # delta wire: (luma codes u8 (H, W), depth codes int32 (h, w)), in place
    *,
    extractor,
    cam,
    cam_small,
    stride: int,
    depth_bits: int,
    dct,
    gray_bits: int,
    fmt: str,
    min_depth: float,
    max_depth: float,
    max_matches: int,
    ratio: float,
    n_hypotheses: int,
    max_mahal_sq: float,
    min_inliers: int,
    emm_skip: int,
    sigma_depth: float,
    sample_size: int,
    refine_iterations: int,
    projective_iterations: int,
    emm_exact: bool,
    edge_info_mode: str,
    observability_threshold: float,
    max_translation_per_s: float,
    max_rotation_deg_per_s: float,
    const_pos_information: float,
    use_feature_min_depth: bool,
) -> torch.Tensor:
    """One frame, written into store/graph in place. Returns the (4B+2,)
    float32 summary on the device."""
    if wire is None:
        kp, depth_small, color_small = prepare_and_extract(
            extractor, cam, stride, min_depth, max_depth, use_feature_min_depth,
            packed, depth_bits, dct, gray_bits, fmt)
    else:
        kp, depth_small, color_small = prepare_and_extract_wire(
            extractor, cam, stride, min_depth, max_depth, use_feature_min_depth,
            packed, intra != 0, wire)
    res = compare_to_candidates(
        kp, depth_small, store, cand_idx, generator, cam_small,
        cam_fx=cam.fx, cam_fy=cam.fy, max_matches=max_matches, ratio=ratio,
        n_hypotheses=n_hypotheses, max_mahal_sq=max_mahal_sq,
        min_inliers=min_inliers, emm_skip=emm_skip, sigma_depth=sigma_depth,
        sample_size=sample_size, refine_iterations=refine_iterations,
        projective_iterations=projective_iterations, cam_cx=cam.cx, cam_cy=cam.cy,
        emm_exact=emm_exact, edge_info_mode=edge_info_mode,
    )
    dev = packed.device
    B = cand_idx.shape[0]

    # ---- accept/reject (nodeComparisons decision logic) -------------------
    if observability_threshold <= 0.0:
        emm_ok = torch.ones(B, dtype=torch.bool, device=dev)
    else:
        emm_ok = (res.emm_quality > observability_threshold) & (res.emm_inlier_frac > 0.25)
    T = res.transform
    trans = torch.linalg.norm(T[:, :3, 3], dim=-1)
    tr = T[:, 0, 0] + T[:, 1, 1] + T[:, 2, 2]
    rot_deg = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)) * (180.0 / math.pi)
    dt = torch.clamp(cand_dt, min=1e-3)
    sane = (trans / dt <= max_translation_per_s) & (rot_deg / dt <= max_rotation_deg_per_s)
    is_pred = cand_idx == pred_id
    accept = res.ransac_ok & emm_ok & ~cand_dup & (sane | ~is_pred)

    # indices stay on the device (index_select, not t[0-dim tensor], which
    # would read the index back to the host)
    any_acc = accept.any()
    score = torch.where(accept, res.n_inliers, -1)
    best = torch.argmax(score).view(1)
    pred = pred_id.reshape(())
    base_id = torch.where(any_acc, cand_idx.index_select(0, best)[0], pred)
    eye4 = torch.eye(4, device=dev)
    base_T_new = torch.where(any_acc, T.index_select(0, best)[0], eye4)

    # ---- edge batch: B visual slots + 1 fallback slot ---------------------
    info_scale = res.n_inliers.float() / torch.clamp(res.rmse * res.rmse, min=1e-4)
    eye6 = torch.eye(6, device=dev)
    vis_info = info_scale[:, None, None] * eye6
    if edge_info_mode == "hessian":
        # the GN information trace-matched to the scalar magnitude, so the
        # protocol's chi2 prune thresholds keep their calibration; a
        # degenerate or rejected candidate keeps the scalar identity
        tr6 = res.info6.diagonal(dim1=-2, dim2=-1).sum(dim=-1) / 6.0
        hess = res.info6 * (info_scale / torch.clamp(tr6, min=1e-12))[:, None, None]
        ok_info = torch.isfinite(hess).flatten(1).all(dim=-1) & (tr6 > 0)
        vis_info = torch.where(ok_info[:, None, None], hess, vis_info)
    fallback = ~any_acc  # keep_all: a constant-position edge when none accepted
    e_i = torch.cat([cand_idx, pred_id]).to(torch.int32)
    e_meas = torch.cat([T, eye4[None]], dim=0)
    fb_info = const_pos_information / torch.clamp(cand_dt[0], min=1e-3)
    e_info = torch.cat([vis_info, (fb_info * eye6)[None]], dim=0)
    e_active = torch.cat([accept, fallback[None]])

    commit_node(store, graph, new_id, kp, depth_small, color_small, base_id.view(1),
                base_T_new, edge_start, e_i, new_id.to(torch.int32).expand(B + 1), e_meas,
                e_info, e_active)

    return torch.cat([
        accept.float(), res.n_inliers.float(), res.rmse, res.emm_quality,
        fallback.float()[None], kp.count().float()[None],
    ])


class GroupInputs(NamedTuple):
    """Inputs of an n-frame step, views of one flat u8 device buffer."""

    packed: torch.Tensor  # (n, L) u8 wires
    new_ids: torch.Tensor  # (n,) long
    pred_ids: torch.Tensor  # (n,) long
    edge_starts: torch.Tensor  # (n,) long
    cand_idx: torch.Tensor  # (n, B) long
    cand_dt: torch.Tensor  # (n, B) float32
    cand_dup: torch.Tensor  # (n, B) u8, nonzero for padding duplicates
    intra: torch.Tensor  # (n,) u8, nonzero for an I wire (read under the delta wire)


def _layout(n: int, L: int, B: int) -> Tuple[int, int, int, int]:
    """Byte offsets of the long block, the float block and the dup and
    intra bytes in the flat input buffer of GroupInputs, and its size."""
    off_long = -(-n * L // 8) * 8
    off_f32 = off_long + 8 * (3 * n + n * B)
    off_dup = off_f32 + 4 * n * B
    return off_long, off_f32, off_dup, off_dup + n * B + n


def group_views(flat: torch.Tensor, n: int, L: int, B: int) -> GroupInputs:
    """GroupInputs as views of a flat u8 buffer (host or device)."""
    off_long, off_f32, off_dup, size = _layout(n, L, B)
    longs = flat[off_long:off_f32].view(torch.int64)
    return GroupInputs(
        packed=flat[: n * L].view(n, L),
        new_ids=longs[:n], pred_ids=longs[n : 2 * n], edge_starts=longs[2 * n : 3 * n],
        cand_idx=longs[3 * n :].view(n, B),
        cand_dt=flat[off_f32:off_dup].view(torch.float32).view(n, B),
        cand_dup=flat[off_dup : size - n].view(n, B),
        intra=flat[size - n : size],
    )


def pack_group(packed: np.ndarray, new_ids, cand_idx, cand_dup, cand_dt, edge_starts,
               pin: bool, intra=None) -> torch.Tensor:
    """One flat u8 host buffer (pinned when `pin`) holding a group's inputs:
    packed (n, L) u8 wires, and per frame its id (pred = id - 1), B
    candidates, dup flags, dt, first edge slot and I-wire flag (0 where
    `intra` is None)."""
    n, L = packed.shape
    B = len(cand_idx[0])
    flat = torch.empty(_layout(n, L, B)[3], dtype=torch.uint8, pin_memory=pin)
    g = group_views(flat, n, L, B)
    g.packed.numpy()[:] = packed
    g.new_ids.numpy()[:] = new_ids
    g.pred_ids.numpy()[:] = np.asarray(new_ids) - 1
    g.edge_starts.numpy()[:] = edge_starts
    g.cand_idx.numpy()[:] = cand_idx
    g.cand_dt.numpy()[:] = cand_dt
    g.cand_dup.numpy()[:] = cand_dup
    g.intra.numpy()[:] = 0 if intra is None else intra
    return flat


def slam_stepN(store: NodeStore, graph: GraphState, g: GroupInputs,
               generator: torch.Generator, wire=None, **cfg) -> torch.Tensor:
    """n consecutive frames in order; frame k's comparison reads frame
    k-1's freshly committed row, and under the delta wire its decode
    predicts from frame k-1's codes (JAX make_slam_stepN). Returns the (n,
    4B+2) summaries."""
    sums = []
    for k in range(g.packed.shape[0]):
        sl = slice(k, k + 1)
        sums.append(slam_step(
            store, graph, g.packed[k], g.new_ids[sl], g.pred_ids[sl], g.cand_idx[k],
            g.cand_dup[k] != 0, g.cand_dt[k], g.edge_starts[sl], generator, g.intra[k], wire,
            **cfg))
    return torch.stack(sums)


def step_key(n: int, L: int, cfg: dict, wire) -> tuple:
    """What a captured step depends on besides its inputs: the group size,
    the FAST threshold (None for SIFT), the wire length and the step's
    options."""
    return (n, getattr(cfg["extractor"], "fast_threshold", None), L, cfg["fmt"],
            cfg["gray_bits"], cfg["depth_bits"], cfg["projective_iterations"], cfg["emm_exact"],
            cfg["edge_info_mode"], wire is not None)


# modules whose LAUNCHES count kernel launches; a capture records its
# launches and a replay adds them
_COUNTED = (detect, alignment, registration)


class _Captured:
    """One captured step: its static input buffer, graph, static output
    and the kernel launches one replay makes."""

    def __init__(self, flat: torch.Tensor):
        self.flat = flat
        self.graph = torch.cuda.CUDAGraph()
        self.out: torch.Tensor = None
        self.launches = (0,) * len(_COUNTED)  # a replay's, as _COUNTED


class CapturedSteps:
    """Step bodies on the card as CUDA graphs, one per key. The first call
    of a key runs its body eagerly, on a side stream between two
    synchronisations: it warms every lazily built constant and library
    handle. The second is captured (every generator in `generators`
    registered with the graph, so a replay draws from each what the eager
    steps would) and replayed; every later one copies its inputs into the
    static buffer (one host->device copy from pinned memory) and replays.
    A capture that fails raises: there is no eager fallback on the card. A
    replay adds the kernel launches its capture recorded to those kernels'
    launch counts."""

    def __init__(self, device: torch.device, generators):
        self.device = device
        self.generators = list(generators)
        self._seen = set()
        self._graphs: Dict[tuple, _Captured] = {}
        self.captures = 0
        self.replays = 0
        self.eager_groups = 0
        self.replay_s = 0.0  # host seconds inside replay calls (graph launches)
        self.capture_s = 0.0  # host seconds inside captures

    def launch(self, key: tuple, host_flat: torch.Tensor, body) -> torch.Tensor:
        """body(flat) on a device copy of `host_flat` (pinned): eagerly,
        captured or replayed, as the key has been seen; returns its output
        in a tensor of its own."""
        cap = self._graphs.get(key)
        if cap is None and key not in self._seen:
            self._seen.add(key)
            self.eager_groups += 1
            flat = host_flat.to(self.device, non_blocking=True)
            side = torch.cuda.Stream(self.device)
            torch.cuda.synchronize(self.device)
            with torch.cuda.stream(side):
                out = body(flat)
            torch.cuda.synchronize(self.device)
            return out
        if cap is None:
            cap = self._capture(key, host_flat, body)
        cap.flat.copy_(host_flat, non_blocking=True)
        t0 = time.perf_counter()
        cap.graph.replay()
        self.replay_s += time.perf_counter() - t0
        self.replays += 1
        for mod, n_launches in zip(_COUNTED, cap.launches):
            mod.LAUNCHES += n_launches
        return cap.out.clone()

    def _capture(self, key, host_flat, body) -> _Captured:
        t0 = time.perf_counter()
        cap = _Captured(torch.empty(host_flat.shape, dtype=torch.uint8, device=self.device))
        for gen in self.generators:
            cap.graph.register_generator_state(gen)
        counts = [mod.LAUNCHES for mod in _COUNTED]
        # Dead reference cycles (an earlier pipeline, say) hold device and
        # pinned host tensors; a collection inside the capture frees them
        # with calls a capturing stream forbids, and the capture fails. So
        # collect first and let no collection run until the capture ends.
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(cap.graph):
                cap.out = body(cap.flat)
        finally:
            if gc_on:
                gc.enable()
            # capturing records the kernels without launching them
            cap.launches = tuple(mod.LAUNCHES - c for mod, c in zip(_COUNTED, counts))
            for mod, c in zip(_COUNTED, counts):
                mod.LAUNCHES = c
        self._graphs[key] = cap
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return cap


class StepGraph(CapturedSteps):
    """slam_stepN on the card as CUDA graphs, one per step_key (n, FAST
    threshold, wire length, step options); SIFT has no FAST threshold (None
    in the key). Under the delta wire `wire` is the manager's pair of code
    tensors, which every replay reads and overwrites."""

    def __init__(self, store: NodeStore, graph: GraphState, generator: torch.Generator,
                 wire=None):
        super().__init__(store.uv.device, [generator])
        self.store, self.graph, self.generator, self.wire = store, graph, generator, wire

    def run(self, host_flat: torch.Tensor, n: int, L: int, B: int, cfg: dict) -> torch.Tensor:
        """Run one group whose inputs are `host_flat` (pack_group, pinned);
        returns its (n, 4B+2) summaries in a tensor of their own."""
        return self.launch(
            step_key(n, L, cfg, self.wire), host_flat,
            lambda flat: slam_stepN(self.store, self.graph, group_views(flat, n, L, B),
                                    self.generator, self.wire, **cfg))
