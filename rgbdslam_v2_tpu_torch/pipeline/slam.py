"""SLAM pipeline: frames -> graph -> trajectories, maps and the 5-level protocol.

Port of ``rgbdslam_v2_tpu/pipeline/slam.py``: ``SlamPipeline.process_frame``,
the run controls (``paused``, ``start_paused``, ``toggle_pause``,
``get_one_frame``, ``request_live_save``, ``set_param``) and the live view
(``live_dir``, ``live_interval``, ``_live_refresh``), ``run_arrays``, ``run_tum``,
``run_bag``, ``run_clouds`` and ``run_stereo`` (frames grouped
``tpu_frames_per_step`` a step on the keep-all fast path, host encodes run
ahead on a worker thread with ``tpu_encode_ahead``; all share one loop over
a frame source, ``_run_frames``), ``save_bagfile``, the online octomap
(``octomap_online_creation``, ``octomap_autosave_step``), the writers
``save_clouds``, ``save_individual_clouds``, ``save_octomap``,
``save_g2o``, ``save_features`` and ``save_mesh`` over
``_node_world_cloud``, ``save_graph_viz``, and ``evaluation_protocol``
with ``EvaluationReport``. The per-frame work runs
under ``torch.inference_mode``. With no ``device`` the pipeline runs on the
CUDA card, or raises where there is none.

Run control (``rgbdslam-torch run --serve``): while paused, a frame is
dropped before any counter moves and no group forms, so the card runs no
step; ``get_one_frame`` lets exactly one frame through. ``set_param`` is
one dict write: the manager re-reads its step configuration every step
call, and on the card a changed value is a new CUDA-graph key
(``device_step.step_key``), run eagerly once and then captured. The
controls flip host state only: the HTTP handler thread that calls them
makes no CUDA call, so it cannot break a capture on the run loop's thread.
With ``live_dir`` set, every ``live_interval`` frames the live view
refreshes estimate.txt, graph.g2o, frame.png (the frame with its
committed keypoints) and depth.png there, and cloud.pcd when a save was
requested, each atomically (a temporary file, then ``os.replace``); the
frames' raw RGB and depth travel beside their wires through the
encode-ahead worker only then. The run loop reads the trajectory, the
graph and the keypoints from the card then, outside the step calls, and
one worker thread writes the files from those host arrays while the next
frames run. Under the delta wire a frame dropped while paused has its
encode undone (``GraphManager.wire_rewind``), as the JAX package encodes
such a wire only at dispatch.

``run_tum`` decodes the PNGs on ``io/tum.TumLoader``'s threads and feeds
the host encoder what the JAX ``run_tum`` feeds its own: ``TumDataset.load``'s
``d16 / 5000`` float32 meters, which the encoder truncates back to counts
(one count low on 7% of the u16 values, ROADMAP F14, a fault of both
packages). Grouping changes no result: 4 frames a step, replayed, give the
trajectory of 1 eager frame a step (``chip_smoke.py`` phase 7), where the
JAX ``run_tum`` feeds one frame a ``process_frame`` call.

``run_stereo`` computes each frame's depth from its rectified pair on the
main thread (``ops/stereo.stereo_depth``; on the card on a stream of its
own, so it does not wait behind the queued SLAM steps) and reads it back
before the frame's host encode: one synchronization a frame, as the JAX
``run_stereo``'s one depth read a frame. Its PNG pairs decode ahead on two
host threads; its encodes run on the main thread (no encode-ahead, whose
worker would issue device work beside the CUDA graph captures).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
from ..graph.ingest import DEPTH_SCALE
from ..graph.manager import GraphManager
from ..interop import tensor_to_numpy
from ..io.tum import TumDataset, TumLoader, write_trajectory
from ..mapping import VoxelMap, VoxelMapConfig
from ..utils import timing


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


def _atomic(out: Path, name: str, write) -> None:
    """write(path) to a temporary name in out, then replace out/name."""
    tmp = out / f".{name}.tmp{Path(name).suffix}"
    write(tmp)
    os.replace(tmp, out / name)


def _live_write(out: Path, stamps, poses, graph, pane) -> float:
    """The live outputs from host arrays (SlamPipeline._live_refresh's
    worker; no CUDA call): estimate.txt, graph.g2o and, with a pane (rgb,
    depth, (uv, valid) of its committed keypoints or None, the depth range),
    depth.png and frame.png. Returns its seconds."""
    from ..graph.g2o_io import write_g2o
    from ..io.render3d import write_png
    from ..io.visualization import draw_feature_flow

    t0 = time.perf_counter()
    _atomic(out, "estimate.txt", lambda t: write_trajectory(t, stamps, poses))
    _atomic(out, "graph.g2o", lambda t: write_g2o(t, *graph))
    if pane is not None:
        rgb, depth, kp, lo, hi = pane
        if depth is not None:
            # the depth pane (the GUI's depth image, misc.cpp:414's mono
            # depthToCV8UC1): metres over [minimum_depth, maximum_depth] as
            # grey, invalid pixels black
            d = np.asarray(depth)
            d = d.astype(np.float32) / DEPTH_SCALE if d.dtype == np.uint16 else d.astype(
                np.float32)
            ok = np.isfinite(d) & (d > 0)
            g = np.clip((d - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
            img_d = np.where(ok, g * 255.0, 0.0).astype(np.uint8)
            _atomic(out, "depth.png", lambda t: write_png(t, np.repeat(img_d[..., None], 3, -1)))
        rgb = np.asarray(rgb)
        if rgb.dtype.kind == "f":
            rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, axis=-1)
        # the frame's own committed keypoints; a dropped frame draws none
        img = rgb if kp is None else draw_feature_flow(rgb, kp[0], kp[0], kp[1])
        _atomic(out, "frame.png", lambda t: write_png(t, img))
    return time.perf_counter() - t0


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
        self._group_tokens = None  # the next group's pose_landed tokens (_run_frames)
        # online octomap creation (graph_manager.cpp:1044-1049)
        self._online_map: Optional[VoxelMap] = None
        self._online_inserts = 0
        self.online_octomap_path = "map_online.ot"
        # interactive run control (pause / step / one frame); start_paused
        # is the reference's wait-for-user startup (parameter_server.cpp:154)
        self.paused = bool(self.params["start_paused"])
        self._step_once = False
        # the live view (run --serve): outputs refreshed into live_dir every
        # live_interval frames; the 2D panes show (rgb, depth, the frame's
        # committed node id or None), the raw frame of the newest frame
        # offered (_last_raw)
        self.live_dir = None
        self.live_interval = 30
        self._live_counter = 0
        self._live_save_requested = False
        self._last_raw = None
        self._live_frame = None
        self._live_pool = None  # the live outputs' writer thread
        self._live_write = None  # its write in flight
        self.live_times = {"refreshes": 0, "read_s": 0.0, "write_s": 0.0}

    # ---- run control (the reference's pause / space / enter semantics:
    # openni_listener.cpp:119-120, :262, :665-749) -----------------------
    def toggle_pause(self) -> bool:
        self.paused = not self.paused
        return self.paused

    def get_one_frame(self) -> None:
        """Process exactly one frame while paused (getOneFrame)."""
        self._step_once = True

    def request_live_save(self) -> None:
        """Queue a cloud save at the next live refresh (the GUI's save
        action, run on the run loop's thread, never on the HTTP handler's)."""
        self._live_save_requested = True

    def set_param(self, name: str, value):
        """Set a parameter during a run (the GUI's setParam dialog and the
        reload_config service: qt_gui.cpp:406-478, ros_service_ui.cpp:67):
        one dict write. The manager reads its parameters each frame and its
        step configuration each step call, so a change takes effect on the
        next one; a step setting costs an eager group and a capture on the
        card. KeyError on an unknown name; returns the coerced value."""
        return self.params.set(name, value)

    def _live_refresh(self, force: bool = False, count: int = 1) -> None:
        """Refresh the live outputs in live_dir once every live_interval
        frames (count: the frames this call stands for), or now with force:
        estimate.txt and graph.g2o (read without a drain, as the JAX
        package writes them), cloud.pcd when a save was requested,
        frame.png with the shown frame's committed keypoints and depth.png.
        The card is read here, on the run loop's thread, between step
        calls; the text, the panes and their PNGs are written on one worker
        thread (numpy and CPU tensors, no CUDA call), at most one refresh
        in flight, and with force this waits for it. Each file is written
        to a temporary name and replaced, so the serving thread never reads
        a torn file. live_times sums each side's seconds."""
        if self.live_dir is None:
            return
        before = self._live_counter
        self._live_counter += count
        iv = max(1, self.live_interval)
        if not force and before // iv == self._live_counter // iv:
            return
        out = Path(self.live_dir)
        out.mkdir(parents=True, exist_ok=True)
        mgr = self.manager
        if mgr.n_nodes == 0:
            return
        t0 = time.perf_counter()
        stamps, poses = mgr.trajectory()
        graph = self._g2o_graph(drain=False)
        if self._live_save_requested:
            self._live_save_requested = False
            _atomic(out, "cloud.pcd", self.save_clouds)
        pane = None
        if self._live_frame is not None:
            rgb, depth, nid = self._live_frame
            kp = None if nid is None else (mgr.store.uv[nid].cpu().numpy(),
                                           mgr.store.kp_valid[nid].cpu().numpy())
            pane = (rgb, depth, kp, float(self.params["minimum_depth"]),
                    float(self.params["maximum_depth"]))
        self.live_times["refreshes"] += 1
        self.live_times["read_s"] += time.perf_counter() - t0
        self.wait_live()
        if self._live_pool is None:
            self._live_pool = ThreadPoolExecutor(1, thread_name_prefix="live-write")
        self._live_write = self._live_pool.submit(_live_write, out, stamps, poses, graph, pane)
        if force:
            self.wait_live()

    def wait_live(self) -> None:
        """Wait for the live outputs' write in flight, if any (its error,
        if it failed, raised here)."""
        if self._live_write is not None:
            fut, self._live_write = self._live_write, None
            self.live_times["write_s"] += fut.result()

    @torch.inference_mode()
    def process_frame(self, rgb, depth, timestamp: float, gt_pose=None,
                      compact=None, token=None) -> bool:
        """One frame (rgb u8 (H, W, 3), depth meters or u16 counts), or a
        pre-packed yc12 buffer. Returns True when the node entered; False
        for a frame dropped while paused, which moves no counter. token:
        the frame's pose_landed, as GraphManager.add_frame's."""
        if self.paused and not self._step_once:
            return False
        self._step_once = False
        if self.live_dir is not None and rgb is not None:
            self._last_raw = (rgb, depth)
        mgr = self.manager
        with timing.span("frames", mgr.n_nodes) as sp:
            took = mgr.add_frame(rgb, depth, timestamp, gt_pose, compact=compact, token=token)
        self.wall_time += sp.elapsed
        self.n_processed += 1
        if not took:
            self.n_dropped += 1
        elif self.params["octomap_online_creation"]:
            self._online_octomap_insert(self.manager.n_nodes - 1)
        if self.live_dir is not None and self._last_raw is not None:
            self._live_frame = (*self._last_raw, self.manager.n_nodes - 1 if took else None)
        self._live_refresh()
        return took

    def _with_raw(self, wire, rgb, depth):
        """A frame as _run_frames takes it: (wire, raw), raw the frame's
        (rgb, depth) with the live view on, whose 2D panes show it, else
        None."""
        return wire, (None if self.live_dir is None else (rgb, depth))

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

    def _frame_indices(self, n: int, max_frames: Optional[int] = None) -> List[int]:
        """The positions of a source's n frames that run: skip_first_n_frames,
        then every data_skip_step-th, at most max_frames of them."""
        p = self.params
        idxs = list(range(p["skip_first_n_frames"], n, max(1, p["data_skip_step"])))
        return idxs[:max_frames] if max_frames else idxs

    @staticmethod
    def _in_order(enc_at):
        """enc_at held to _run_frames' contract: each position asked for
        once, in increasing order (a loader hands frames out in order, and
        the delta wire's encode advances with each call)."""
        expected = [0]

        def guarded(pos):
            if pos != expected[0]:
                raise RuntimeError(f"frame {pos} asked for out of order (next {expected[0]})")
            expected[0] += 1
            return enc_at(pos)

        return guarded

    def run_arrays(self, rgbs, depths, stamps, gt_poses=None) -> None:
        """Feed pre-loaded host arrays (skip_first_n_frames, data_skip_step
        honoured); the first processed frame is anchored at its ground-truth
        pose when given."""
        idxs = self._frame_indices(len(rgbs))
        if not idxs:
            return
        mgr = self.manager

        def enc_at(pos):
            rgb, depth = rgbs[idxs[pos]], depths[idxs[pos]]
            return self._with_raw(mgr.encode(rgb, depth), rgb, depth)

        self._run_frames([float(stamps[i]) for i in idxs], enc_at,
                         None if gt_poses is None else gt_poses[idxs[0]])

    def run_tum(self, dataset: TumDataset, max_frames: Optional[int] = None) -> dict:
        """Process a TUM dataset (skip_first_n_frames, data_skip_step and
        max_frames honoured): the PNGs decode on TumLoader's threads, ahead
        of the encodes, in order. Returns the loader's waits: {"waits":
        frames asked for before their decode finished, "wait_s": seconds
        spent waiting for them}."""
        idxs = self._frame_indices(len(dataset), max_frames)
        if not idxs:
            return {"waits": 0, "wait_s": 0.0}
        mgr = self.manager
        loader = TumLoader(dataset, idxs)

        def enc_at(pos):
            _ts, rgb, depth = next(loader)
            return self._with_raw(mgr.encode(rgb, depth), rgb, depth)

        try:
            self._run_frames([dataset.pairs[i][0] for i in idxs], self._in_order(enc_at), None)
        finally:
            loader.close()
        return {"waits": loader.waits, "wait_s": loader.wait_s}

    def run_bag(self, bag_path, max_frames: Optional[int] = None) -> None:
        """ROS bag playback, the reference's offline entry (processBagfile,
        src/openni_listener.cpp:218-340): the bag's RGB (topic_image_mono)
        and depth (topic_image_depth) messages are paired by approximate time
        up front (drop_async_frames honoured), so the kept frames' stamps are
        known; each frame's arrays decode from the bag when its encode runs
        (skip_first_n_frames, data_skip_step, max_frames and
        depth_scaling_factor honoured, as in the JAX run_bag). The intrinsics
        are the pipeline's: the bag's CameraInfo is not read, as in the JAX
        package (ROADMAP F5)."""
        from ..io.rosbag import pair_rgbd_messages

        p = self.params
        pairs = pair_rgbd_messages(bag_path, rgb_topic=p["topic_image_mono"],
                                   depth_topic=p["topic_image_depth"],
                                   drop_async=p["drop_async_frames"])
        idxs = self._frame_indices(len(pairs), max_frames)
        if not idxs:
            return
        mgr = self.manager

        def enc_at(pos):
            rgb, depth = (m.as_array() for m in pairs[idxs[pos]])
            return self._with_raw(mgr.encode(rgb, depth), rgb, depth)

        self._run_frames([pairs[i][0].stamp for i in idxs], self._in_order(enc_at), None)

    def run_clouds(self, source, max_frames: Optional[int] = None) -> None:
        """Point-cloud input (the reference's second Node ctor,
        node.cpp:252-369; pcdCallback, openni_listener.cpp:536; PCD file
        loading :1063-1100). ``source`` is an io.cloud_input.CloudDataset,
        whose files load when their encode runs, or an iterable of (stamp,
        points, colors), whose kept clouds are taken up front and converted
        when their encode runs. Clouds become the organized RGB-D grid
        (cloud_to_rgbd) at this boundary, so the same per-frame step runs
        (skip_first_n_frames, data_skip_step, max_frames and
        depth_scaling_factor honoured, as in the JAX run_clouds)."""
        from ..io.cloud_input import cloud_to_rgbd

        mgr = self.manager
        if hasattr(source, "load"):
            idxs = self._frame_indices(len(source), max_frames)
            stamps = [source.stamps[i] for i in idxs]

            def enc_at(pos):
                _ts, rgb, depth = source.load(idxs[pos])
                return self._with_raw(mgr.encode(rgb, depth), rgb, depth)
        else:
            p = self.params
            skip0, step = p["skip_first_n_frames"], max(1, p["data_skip_step"])
            clouds = []
            for k, item in enumerate(source):
                if max_frames and len(clouds) >= max_frames:
                    break
                if k >= skip0 and (k - skip0) % step == 0:
                    clouds.append(item)
            stamps = [c[0] for c in clouds]

            def enc_at(pos):
                _ts, pts, cols = clouds[pos]
                rgb, depth = cloud_to_rgbd(pts, cols, self.cam)
                return self._with_raw(mgr.encode(rgb, depth), rgb, depth)
        if stamps:
            self._run_frames(stamps, self._in_order(enc_at), None)

    def run_stereo(self, source, max_frames: Optional[int] = None) -> None:
        """The stereo input (the reference's stereoCallback,
        openni_listener.cpp:559-598): ``source`` is an
        io.stereo_input.StereoDataset (or has its ``pairs`` and ``load``).
        Each kept pair's block-matching depth (stereo_baseline,
        stereo_max_disparity, stereo_block_size) is computed on the
        pipeline's device and read back, and the left RGB with that depth
        takes the per-frame path of every input (skip_first_n_frames,
        data_skip_step and max_frames honoured; the depth is not scaled by
        depth_scaling_factor, as in the JAX run_stereo). The pairs' PNGs
        decode two frames ahead on host threads."""
        idxs = self._frame_indices(len(source), max_frames)
        if not idxs:
            return
        mgr = self.manager
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        loads = ThreadPoolExecutor(2, thread_name_prefix="stereo-load")
        futs = {}

        def enc_at(pos):
            for q in (pos, pos + 1, pos + 2):
                if q < len(idxs) and q not in futs:
                    futs[q] = loads.submit(source.load, idxs[q])
            _ts, rgb, gl, gr = futs.pop(pos).result()
            depth = self.stereo_depth(gl, gr, stream)
            return self._with_raw(mgr.encode(rgb, depth, scale_depth=False), rgb, depth)

        try:
            self._run_frames([source.pairs[i][0] for i in idxs], self._in_order(enc_at), None,
                             ahead=False)
        finally:
            loads.shutdown(wait=True, cancel_futures=True)

    @torch.inference_mode()
    def stereo_depth(self, gl, gr, stream=None) -> np.ndarray:
        """A rectified grey pair (H, W) float32 in [0, 1] -> host depth
        (H, W) float32 metres, 0 where invalid, computed on the pipeline's
        device (on `stream` where given) with one synchronization."""
        from ..ops.stereo import stereo_depth

        p = self.params
        pair = torch.from_numpy(np.stack([np.asarray(gl, np.float32),
                                          np.asarray(gr, np.float32)]))
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            if self.device.type == "cuda":  # from pinned memory: no synchronization
                pair = pair.pin_memory()
            pair = pair.to(self.device, non_blocking=True)
            depth, _ = stereo_depth(pair[0], pair[1], self.cam.fx, float(p["stereo_baseline"]),
                                    int(p["stereo_max_disparity"]), int(p["stereo_block_size"]))
            return depth.cpu().numpy()

    def save_bagfile(self, path, include_clouds: bool = False) -> str:
        """The optimized result as a bag (saveBagfile,
        src/graph_mgr_io.cpp:102-150): one /map -> /camera tf a node at its
        stamp; with include_clouds also each node's stored stride-s depth
        (32FC1 meters, on topic_image_depth) and, where the store keeps
        colour, its colour (rgb8, on topic_image_mono)."""
        from ..io.rosbag import BagWriter, TransformStamped

        mgr = self.manager
        stamps, poses = mgr.trajectory()
        quats = se3.rot_to_quat(torch.from_numpy(poses[:, :3, :3])).numpy()
        cs = mgr.cam_small
        with BagWriter(path) as bag:
            for nid, (t, T) in enumerate(zip(stamps, poses)):
                bag.write_tf([TransformStamped(float(t), "/map", "/camera", T[:3, 3].copy(),
                                               quats[nid])])
                if include_clouds:
                    depth = mgr.store.depth[nid].view(cs.height, cs.width).cpu().numpy()
                    bag.write_image(self.params["topic_image_depth"], float(t), depth)
                    if mgr.store.color.shape[1] > 3:
                        rgb = mgr.store.color[nid].view(cs.height, cs.width, 3).cpu().numpy()
                        bag.write_image(self.params["topic_image_mono"], float(t), rgb)
        return str(path)

    def _run_frames(self, stamps, enc_at, gt0, ahead: bool = True) -> None:
        """The frames of a source, in order: enc_at(pos) is frame pos's host
        wire, asked for once a position, in increasing order; gt0 anchors
        the first node. Where the manager can group them, frames go
        tpu_frames_per_step (clamped to [1, 8]) at a time through one step
        call, the tail in a shorter group. With
        tpu_encode_ahead one worker thread keeps the next two host encodes
        in flight (the same wires, so the same result). Under the delta
        wire the encodes wait for their dispatch (the host mirror advances
        with each) and groups hold at most 2 frames, as in the JAX
        package. ahead=False runs every encode on the calling thread. While
        paused no group forms: each frame goes to process_frame, which drops
        it (or lets one through on get_one_frame); a dropped frame was read
        and encoded, in order, but under the delta wire its encode is
        undone, since the host mirror follows the codes the card decoded.
        enc_at's items are (wire, raw) (_with_raw); with the live view on
        the live outputs refresh after each step call, outside it."""
        p = self.params
        mgr = self.manager
        n = len(stamps)
        ngroup = max(1, min(int(p["tpu_frames_per_step"]), 8))  # the JAX package's clamp
        if mgr.wire_delta:
            ngroup = min(ngroup, 2)
        ex = (ThreadPoolExecutor(1, thread_name_prefix="encode-ahead")
              if ahead and p["tpu_encode_ahead"] and not mgr.wire_delta and n > 1 else None)
        futs = {}

        def taken_at(pos):
            # a frame's pose_landed opens as the program takes it
            return timing.begin("pose_landed"), *enc_at(pos)

        def get_enc(pos):
            if ex is None:
                return taken_at(pos)
            f = futs.pop(pos, None)
            if f is None:
                out = taken_at(pos)
            else:
                with timing.span("encode.wait", pos):
                    out = f.result()
            for q in (pos + 1, pos + 2):
                if q < n and q not in futs:
                    futs[q] = ex.submit(taken_at, q)
            return out

        try:
            k = 0
            while k < n:
                mark = mgr.wire_mark()
                tok, cpt, raw = get_enc(k)
                g = min(ngroup, n - k)
                if g >= 2 and not self.paused and mgr.can_group(g):
                    items = [(tok, cpt, raw)] + [get_enc(k + m) for m in range(1, g)]
                    self._group_tokens = [t for t, _, _ in items]
                    self._process_group([c for _, c, _ in items],
                                        [float(t) for t in stamps[k : k + g]])
                    if items[-1][2] is not None:  # the panes show the group's last frame
                        self._live_frame = (*items[-1][2], mgr.n_nodes - 1)
                    self._live_refresh(count=g)
                    k += g
                    continue
                gt = gt0 if mgr.n_nodes == 0 else None
                if raw is not None:
                    self._last_raw = raw
                done = self.n_processed
                self.process_frame(None, None, float(stamps[k]), gt, compact=cpt, token=tok)
                if self.n_processed == done:  # dropped while paused
                    mgr.wire_rewind(mark)
                k += 1
        finally:
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)

    @torch.inference_mode()
    def _process_group(self, compacts, stamps) -> None:
        """Frames that all enter the graph (keep-all): one step call. Their
        pose_landed tokens: those _run_frames took them with, else new."""
        tokens, self._group_tokens = self._group_tokens, None
        with timing.span("frames", self.manager.n_nodes) as sp:
            self.manager.add_frame_group(compacts, stamps, tokens=tokens)
        self.wall_time += sp.elapsed
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
        with timing.span("protocol"):
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

    def save_mesh(self, path, node_stride: int = 1, jump_frac: float = 0.05) -> int:
        """Triangle-mesh every node_stride-th node's organized grid into one
        world-frame PLY (the GL viewer's triangle strips with their
        depth-jump test, glviewer.cpp:776-880, kept as an indexed mesh).
        Returns the face count."""
        from ..io.meshing import compact_mesh, grid_mesh_faces, merge_meshes, write_ply_mesh

        mgr = self.manager
        hw = (mgr.cam_small.height, mgr.cam_small.width)
        parts = []
        for nid in range(0, mgr.n_nodes, max(1, node_stride)):
            pts, cols, valid, _ = self._node_world_cloud(nid)
            depth = mgr.store.depth[nid].view(hw).cpu().numpy()
            faces = grid_mesh_faces(depth, valid.view(hw).cpu().numpy(), jump_frac)
            parts.append(compact_mesh(pts.cpu().numpy(), cols.cpu().numpy(), faces))
        verts, cols, faces = merge_meshes(parts)
        write_ply_mesh(path, verts, cols, faces)
        return len(faces)

    def save_graph_viz(self, path) -> int:
        """Graph nodes and edges as a PLY line set coloured by edge type
        (the RViz markers, graph_mgr_io.cpp:687-932). Returns the edges
        written."""
        from ..io.visualization import export_graph_ply

        mgr = self.manager
        mgr._drain_pending()
        return export_graph_ply(path, mgr.poses(), mgr.host.edge_pairs,
                                mgr.graph.edge_active.cpu().numpy(), mgr.host.edge_types)

    def save_g2o(self, path, drain: bool = True) -> None:
        """The pose graph in g2o text format (saveG2OGraph): every node, the
        fixed ones, the active edges; the pending summaries drained first
        unless drain is False (the live view, which reads the card's graph
        as it stands, as the JAX package's save_g2o does)."""
        from ..graph.g2o_io import write_g2o

        write_g2o(path, *self._g2o_graph(drain))

    def _g2o_graph(self, drain: bool):
        """save_g2o's graph read from the card: (poses, fixed ids, active
        edges as (i, j, measurement, information))."""
        mgr = self.manager
        if drain:
            mgr._drain_pending()
        g = mgr.graph
        n, m = mgr.n_nodes, mgr.n_edges
        fixed = np.nonzero(g.node_fixed[:n].cpu().numpy())[0].tolist()
        active = g.edge_active[:m].cpu().numpy()
        ei, ej = g.edge_i[:m].cpu().numpy(), g.edge_j[:m].cpu().numpy()
        meas, info = g.edge_meas[:m].cpu().numpy(), g.edge_info[:m].cpu().numpy()
        return mgr.poses(), fixed, [(int(ei[e]), int(ej[e]), meas[e], info[e])
                                    for e in range(m) if active[e]]

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
