#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rgbdslam_v2_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py [--frames N]

Phases, each printing one or more lines; any failed check exits non-zero
and prints no result:
  1. device and build: the card's name and power limit (nvidia-smi), torch
     and CUDA versions, and the time to build csrc/detect_corners.cu;
  2. kernel against plain: the one-launch detect kernel on the four pyramid
     levels of a 640x480 frame the port renders, against its plain torch
     version on each level, at thresholds 0.06, 0.015 and 0.001875 (the
     adaptive detector's highest, middle and lowest): equal corner masks
     and max abs error 0.0, or it fails. Then its time at 480x640 (level 0
     alone) and for the frame (four levels, one launch): the mean device
     time of the kernel over 20 calls from a torch.profiler trace, the
     median of 20 CUDA-event spans around the call (host dispatch
     included), the same for the plain version, and the bound (bytes read
     and written at 3.35 TB/s, or float operations at 67 TFLOP/s, the
     larger) with the kernel's share of it; and the device time of the
     whole detect stage of a frame, the pyramid's resizes included;
  3. main path: the bench sequence (orbit in the synthetic room, 640x480,
     depth noise 0.01 z^2 with 1/5000 m quantization) rendered on the card,
     run through SlamPipeline(device="cuda") in the keep-all configuration
     (ORB-600 over 4 levels, 8 candidates, RANSAC-200, EMM on); prints fps
     over the frames after the 20 warm-up frames, the graph statistics and
     the detect kernel's launch count, which must equal the frames
     processed (one launch a frame);
  4. protocol: the 5-level evaluation protocol, ATE L0..L4 against the exact
     ground truth; L4 must be at most 0.03 m;
  5. default configuration: SlamPipeline(TUM_DEFAULT, default_params(),
     device="cuda") unchanged (ORB-600 over 4 levels, 8 candidates,
     RANSAC-200, observability_threshold=0, the host-decision path with
     motion gates and keyframes, online PCG optimize of every node: 3 LM x
     24 CG iterations; 4096-node / 65536-edge capacity) on the first
     DEFAULT_FRAMES frames of the same sequence, 20 warm-up frames; prints
     fps, the graph (nodes, dropped frames, sequential / loop /
     constant-position edges, keyframes), detect launches a frame (must be
     1), the median ms of one online optimize (host clock, synchronized),
     peak device memory and the protocol's ATE L0..L4 (finite, L4 at most
     DEFAULT_ATE_L4_MAX), and fails if any optimize used the dense solver.
     Phases 3-4 are not cut: the whole run stays within twice the time of
     the run before phase 5 was added.
Before the last line it prints one JSON object with the kernels' measured
numbers; the last line is {"ok": true, "device": {...}}.

bench_params() and render_bench() hold the cell's configuration and data;
tools/profile_torch_port.py imports them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
THRESHOLDS = (0.06, 0.015, 0.001875)  # FAST thresholds held bitwise
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# float operations a pixel of the plain version: Sobel 20 + products 3 +
# two 5-tap blurs of three maps 54 + Harris 7 + FAST 2 + 32 compares + NMS 9
DETECT_OPS_PER_PX = 127
ATE_L4_MAX = 0.03  # metres
# The default configuration closes no loop (its 8 candidate slots go to 4
# predecessors and 4 geodesic neighbours, none to sampled keyframes), so it
# drifts: the JAX package itself reads L4 0.0562 m on this trajectory at
# 160x120 over 300 frames (tools/default_path_ate.py, on the CPU). Bound:
# that x 1.5.
DEFAULT_ATE_L4_MAX = 1.5 * 0.0562  # metres
WARMUP = 20  # frames before the timed run, as in bench.py
DEFAULT_FRAMES = 300  # frames of the default-configuration phase
WORLD_SEED = 0  # synthetic world (textures, boxes)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, n: int = 20) -> float:
    import torch

    fn()  # warm
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int = 20):
    """Mean device time of one call of fn: the summed durations of the device
    activities (kernels, copies) a torch.profiler trace of n calls records.
    None when the trace holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start
             for e in prof.events() if e.device_type.name == "CUDA"]
    return sum(spans) / n / 1e3 if spans else None


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def bench_params():
    """The keep-all VGA cell: bench.py's make_pipe with the ported slice's
    path selectors (yc12 ingest, one frame per step, no encode-ahead,
    pose_relative_to=first, synchronous drains)."""
    from rgbdslam_v2_tpu_torch.config import ParameterServer

    return ParameterServer(dict(
        max_keypoints=600, tpu_max_nodes=1024, tpu_max_edges=8192, tpu_candidate_batch=8,
        ransac_iterations=200, optimizer_skip_step=10, keep_all_nodes=True,
        observability_threshold=0.5, pose_relative_to="first", emm_skip_step=4,
        tpu_ingest_format="yc12", tpu_gray_bits=8, tpu_depth_bits=10,
        tpu_frames_per_step=1, tpu_encode_ahead=False, tpu_drain_pipelined=False,
    ))


def render_bench(world, frames: int, device):
    """The bench sequence rendered on device: (poses, rgb u8, depth u16 TUM
    counts, stamps) with depth noise 0.01 z^2 and 1/5000 m quantization."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.io import render_sequence

    poses, rgbs, depths = render_sequence(world, frames, seed=2,
                                          depth_noise_sigma=0.01, device=device)
    depths = np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    return poses, rgbs, depths, np.arange(frames) / 30.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=520)
    args = ap.parse_args()
    if args.frames <= WARMUP + 2:
        fail(f"--frames must be at least {WARMUP + 3}")
    n_default = min(DEFAULT_FRAMES, args.frames)

    if not (ROOT / "rgbdslam_v2_tpu_torch" / "csrc" / "detect_corners.cu").is_file():
        fail(f"the port package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from rgbdslam_v2_tpu_torch import backend
    from rgbdslam_v2_tpu_torch.config import default_params
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence
    from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor
    from rgbdslam_v2_tpu_torch.ops import detect, fast
    from rgbdslam_v2_tpu_torch.ops.image import resize_bilinear
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    dev = backend.resolve_device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    phase(smi_line)
    t0 = time.perf_counter()
    lib_path = backend.build_kernel_library("detect_corners")
    backend.load_kernel_library("detect_corners")
    build_s = time.perf_counter() - t0
    phase(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | detect_corners built in {build_s:.2f} s "
          f"({lib_path.name})")

    # ---- 2. kernel against plain: the frame's 4 levels, one launch ------
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    _, rgb0, _ = render_sequence(world, 1, seed=2, device=dev)
    rgb = torch.from_numpy(rgb0[0]).to(dev).to(torch.int32)
    gray8 = (rgb[..., 0] * 77 + rgb[..., 1] * 150 + rgb[..., 2] * 29) >> 8  # ingest's luma
    gray = gray8.float() * (1.0 / 255.0)
    with torch.inference_mode():
        images = OrbExtractor().pyramid(gray)
        shapes = [tuple(img.shape) for img in images]
        for img in images[1:]:  # written into padded rows: the unpadded bits
            if not torch.equal(img, resize_bilinear(gray, tuple(img.shape))):
                fail(f"the padded resize to {tuple(img.shape)} differs from the unpadded one")
        max_abs = 0.0
        for thr in THRESHOLDS:
            maps = detect.detect_pyramid(images, thr)
            counts = []
            for img, got in zip(images, maps):
                ref = fast.detect_corners(img, thr)
                torch.cuda.synchronize()
                mg, mr = torch.isfinite(got), torch.isfinite(ref)
                if not torch.equal(mg, mr):
                    fail(f"corner mask differs at {tuple(img.shape)}, threshold {thr}: "
                         f"{int((mg != mr).sum())} pixels")
                err = float((got[mr] - ref[mr]).abs().max()) if bool(mr.any()) else 0.0
                if err != 0.0 or not torch.equal(got, ref):
                    fail(f"scores differ at {tuple(img.shape)}, threshold {thr}: "
                         f"max abs err {err:.3e}")
                max_abs = max(max_abs, err)
                counts.append(int(mr.sum()))
            if min(counts) < 50:
                fail(f"only {min(counts)} corners on a level at threshold {thr}")
            phase(f"[2 kernel] threshold {thr}: one launch, 4 levels "
                  f"{' / '.join(f'{h}x{w}' for h, w in shapes)}: masks equal, max abs err "
                  f"0.0, corners {' / '.join(map(str, counts))}")

        px_frame = sum(h * w for h, w in shapes)
        times = {}
        for key, px, call in (
            ("level0", shapes[0][0] * shapes[0][1],
             lambda: detect.detect_pyramid(images[:1], 0.06)),
            ("level0_plain", None, lambda: fast.detect_corners(images[0], 0.06)),
            ("frame", px_frame, lambda: detect.detect_pyramid(images, 0.06)),
            ("frame_plain", None, lambda: [fast.detect_corners(im, 0.06) for im in images]),
        ):
            times[key] = (device_ms(call), median_ms(call))
            if px is not None:
                bytes_ms = 8.0 * px / HBM_BYTES_PER_S * 1e3
                ops_ms = DETECT_OPS_PER_PX * px / FP32_OPS_PER_S * 1e3
                bound = max(bytes_ms, ops_ms)
                times[key + "_bound"] = (bound, "bytes" if bytes_ms >= ops_ms else "operations")
        for key, label in (("level0", "480x640 (level 0 alone)"), ("frame", "frame (4 levels)")):
            (dk, ek), (dp, ep) = times[key], times[key + "_plain"]
            bound, by = times[key + "_bound"]
            share = "not measured" if dk is None else f"{100.0 * bound / dk:.1f}%"
            phase(f"[2 kernel] {label}: kernel device {fmt_ms(dk)} (profiler, mean of 20), "
                  f"event span {ek:.4f} ms (median of 20); plain device {fmt_ms(dp)}, event "
                  f"span {ep:.4f} ms; bound {bound * 1e3:.3f} us ({by}); share of bound {share}")
        stage = device_ms(lambda: detect.detect_pyramid(OrbExtractor().pyramid(gray), 0.06))
        phase(f"[2 kernel] pyramid + detect stage a frame (three resizes written in place, one "
              f"launch): device {fmt_ms(stage)} (profiler, mean of 20)")

    # ---- 3. main path --------------------------------------------------
    t0 = time.perf_counter()
    poses, rgbs, depths, stamps = render_bench(world, args.frames, dev)
    phase(f"[3 main] rendered {args.frames} frames 640x480 on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    detect.reset_launches()  # count only the main path's launches
    pipe = SlamPipeline(TUM_DEFAULT, bench_params(), device=dev)
    for i in range(WARMUP):
        pipe.process_frame(rgbs[i], depths[i], float(stamps[i]),
                           gt_pose=poses[0] if i == 0 else None)
    pipe.manager.optimize(blocking=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.params.set("skip_first_n_frames", WARMUP)
    pipe.run_arrays(rgbs, depths, stamps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = detect.LAUNCHES
    fps = (args.frames - WARMUP) / dt
    stats = pipe.manager.statistics()
    phase(f"[3 main] {fps:.2f} fps over {args.frames - WARMUP} frames "
          f"({1e3 * dt / (args.frames - WARMUP):.2f} ms/frame, compact encode included); "
          f"nodes {stats['nodes']}, edges {stats['edges']} ({stats['active_edges']} active, "
          f"{stats['sequential_edges']} sequential, {stats['loop_edges']} loop), keyframes "
          f"{stats['keyframes']}; detect launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if pipe.n_processed != args.frames or stats["nodes"] != args.frames:
        fail(f"processed {pipe.n_processed} frames, {stats['nodes']} nodes; "
             f"expected {args.frames}")
    if launches != pipe.n_processed:
        fail(f"detect kernel launched {launches} times, expected one a frame "
             f"({pipe.n_processed})")
    n_main = pipe.n_processed

    # ---- 4. protocol ---------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
    est = pipe.manager.poses()
    if est.shape != (args.frames, 4, 4) or not np.isfinite(est).all():
        fail(f"trajectory has shape {est.shape} or non-finite poses")
    ate = [rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)]
    phase(f"[4 protocol] ATE L0..L4 {' / '.join(f'{a:.4f}' for a in ate)} m "
          f"(in {time.perf_counter() - t0:.1f} s; limit L4 <= {ATE_L4_MAX})")
    if not all(np.isfinite(ate)):
        fail(f"protocol ATE not finite: {ate}")
    if ate[4] > ATE_L4_MAX:
        fail(f"protocol ATE L4 {ate[4]:.4f} m above {ATE_L4_MAX} m")

    # ---- 5. default configuration -------------------------------------
    del pipe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    detect.reset_launches()
    pipe = SlamPipeline(TUM_DEFAULT, default_params(), device=dev)
    mgr = pipe.manager
    online_ms = []
    online = mgr.optimize

    def timed_optimize(*a, **kw):  # host clock around one synchronized optimize
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = online(*a, **kw)
        torch.cuda.synchronize()
        online_ms.append(1e3 * (time.perf_counter() - t))
        return out

    mgr.optimize = timed_optimize
    sl = slice(0, n_default)
    pipe.run_arrays(rgbs[:WARMUP], depths[:WARMUP], stamps[:WARMUP], gt_poses=poses[sl])
    torch.cuda.synchronize()
    online_ms.clear()
    t0 = time.perf_counter()
    pipe.run_arrays(rgbs[WARMUP:n_default], depths[WARMUP:n_default], stamps[WARMUP:n_default])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del mgr.optimize
    launches_default = detect.LAUNCHES
    fps_default = (n_default - WARMUP) / dt
    stats = mgr.statistics()
    n_const = sum(t == EDGE_CONST_POSITION for t in mgr.host.edge_types)
    peak_default = torch.cuda.max_memory_allocated() / 2**30
    phase(f"[5 default] {fps_default:.2f} fps over {n_default - WARMUP} frames "
          f"({1e3 * dt / (n_default - WARMUP):.2f} ms/frame, compact encode included); "
          f"nodes {stats['nodes']}, dropped frames {pipe.n_dropped}, edges {stats['edges']} "
          f"({stats['sequential_edges']} sequential, {stats['loop_edges']} loop, {n_const} "
          f"constant-position), keyframes {stats['keyframes']}; detect launches "
          f"{launches_default} for {pipe.n_processed} frames; online optimize median "
          f"{statistics.median(online_ms):.2f} ms over {len(online_ms)} calls "
          f"(min {min(online_ms):.2f}, max {max(online_ms):.2f}); solver calls "
          f"{mgr.solver_calls}; peak device memory {peak_default:.2f} GiB")
    if pipe.n_processed != n_default or stats["nodes"] + pipe.n_dropped != n_default:
        fail(f"processed {pipe.n_processed} frames: {stats['nodes']} nodes and "
             f"{pipe.n_dropped} dropped; expected {n_default} frames")
    if launches_default != pipe.n_processed:
        fail(f"detect kernel launched {launches_default} times on the default path, "
             f"expected one a frame ({pipe.n_processed})")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps[sl]),
                                       gt_xyz=poses[sl, :3, 3])
    est = mgr.poses()
    if est.shape != (stats["nodes"], 4, 4) or not np.isfinite(est).all():
        fail(f"default-configuration trajectory has shape {est.shape} or non-finite poses")
    ate_d = [rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)]
    phase(f"[5 default] protocol ATE L0..L4 {' / '.join(f'{a:.4f}' for a in ate_d)} m "
          f"(in {time.perf_counter() - t0:.1f} s; limit L4 <= {DEFAULT_ATE_L4_MAX:.4f}); "
          f"solver calls {mgr.solver_calls}")
    if mgr.solver_calls["dense"] or not mgr.solver_calls["pcg"]:
        fail(f"the default configuration's optimize used the dense solver: "
             f"{mgr.solver_calls}")
    if not all(np.isfinite(ate_d)):
        fail(f"default-configuration ATE not finite: {ate_d}")
    if ate_d[4] > DEFAULT_ATE_L4_MAX:
        fail(f"default-configuration ATE L4 {ate_d[4]:.4f} m above {DEFAULT_ATE_L4_MAX:.4f} m")

    phase(f"[done] total {time.perf_counter() - t_start:.1f} s")
    (dk, ek), (dp, ep) = times["frame"], times["frame_plain"]
    bound, by = times["frame_bound"]
    phase(json.dumps({"kernels": [{
        "name": "detect_corners",
        "route": "cuda",
        "source": "rgbdslam_v2_tpu_torch/csrc/detect_corners.cu",
        "replaces": "rgbdslam_v2_tpu/ops/pallas_detect.py:122",
        "launches": launches,
        "launches_per_frame": launches / n_main,
        "launches_default": launches_default,
        "launches_per_frame_default": launches_default / pipe.n_processed,
        "max_abs_err": max_abs,
        # one frame's four levels, profiler device time (null where the trace
        # held no device activity; the event spans below include the host)
        "ms": dk,
        "plain_ms": dp,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes FAST-9 + Harris + NMS
        "event_ms": ek,
        "plain_event_ms": ep,
        "level0_ms": times["level0"][0],
        "level0_bound_ms": times["level0_bound"][0],
        "stage_ms": stage,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
