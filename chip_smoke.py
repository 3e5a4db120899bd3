#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rgbdslam_v2_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py [--frames N]

Phases, each printing one line; any failed check exits non-zero and prints
no result:
  1. device and build: the card's name and power limit (nvidia-smi), torch
     and CUDA versions, and the time to build csrc/detect_corners.cu;
  2. kernel against plain: the hand-written detect kernel against its plain
     torch version at the 4 pyramid-level shapes of a 640x480 frame the
     port renders (corner mask equal, scores within rtol 2e-4), with each
     one's time per call: the median of 20 CUDA-event spans around the call
     (host dispatch included), and the mean device time of its kernels over
     20 calls from a torch.profiler trace;
  3. main path: the bench sequence (orbit in the synthetic room, 640x480,
     depth noise 0.01 z^2 with 1/5000 m quantization) rendered on the card,
     run through SlamPipeline(device="cuda") in the keep-all configuration
     (ORB-600 over 4 levels, 8 candidates, RANSAC-200, EMM on); prints fps
     over the frames after the 20 warm-up frames, the graph statistics and the detect
     kernel's launch count, which must equal 4 x the frames processed;
  4. protocol: the 5-level evaluation protocol, ATE L0..L4 against the exact
     ground truth; L4 must be at most 0.03 m.
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
RTOL = 2e-4  # score tolerance of the kernel against its plain version
ATE_L4_MAX = 0.03  # metres
WARMUP = 20  # frames before the timed run, as in bench.py
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

    if not (ROOT / "rgbdslam_v2_tpu_torch" / "csrc" / "detect_corners.cu").is_file():
        fail(f"the port package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from rgbdslam_v2_tpu_torch import backend
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
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

    # ---- 2. kernel against plain at the 4 level shapes ------------------
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    _, rgb0, _ = render_sequence(world, 1, seed=2, device=dev)
    rgb = torch.from_numpy(rgb0[0]).to(dev).to(torch.int32)
    gray8 = (rgb[..., 0] * 77 + rgb[..., 1] * 150 + rgb[..., 2] * 29) >> 8  # ingest's luma
    gray = gray8.float() * (1.0 / 255.0)
    shapes = OrbExtractor().level_shapes(TUM_DEFAULT.height, TUM_DEFAULT.width)
    max_abs = max_rel = 0.0
    ms_total = plain_ms_total = 0.0
    dev_ms, plain_dev_ms = [], []
    with torch.inference_mode():
        for lvl, shape in enumerate(shapes):
            img = gray if lvl == 0 else resize_bilinear(gray, shape).contiguous()
            got = detect.detect_corners(img, 0.06)
            ref = fast.detect_corners(img, 0.06)
            torch.cuda.synchronize()
            mg, mr = torch.isfinite(got), torch.isfinite(ref)
            n_corner = int(mr.sum())
            if not torch.equal(mg, mr):
                fail(f"corner mask differs at {shape}: {int((mg != mr).sum())} pixels")
            if n_corner < 50:
                fail(f"only {n_corner} corners at {shape}")
            diff = (got[mr] - ref[mr]).abs()
            rel = float((diff / ref[mr].abs().clamp_min(1e-12)).max())
            if not bool((diff <= RTOL * ref[mr].abs() + 1e-6).all()):
                fail(f"scores differ at {shape}: max rel {rel:.3e} > {RTOL}")
            max_abs = max(max_abs, float(diff.max()))
            max_rel = max(max_rel, rel)
            ms = median_ms(lambda: detect.detect_corners(img, 0.06))
            plain_ms = median_ms(lambda: fast.detect_corners(img, 0.06))
            ms_total += ms
            plain_ms_total += plain_ms
            dev_ms.append(device_ms(lambda: detect.detect_corners(img, 0.06)))
            plain_dev_ms.append(device_ms(lambda: fast.detect_corners(img, 0.06)))
            phase(f"[2 kernel] level {lvl} {shape[0]}x{shape[1]}: mask equal, {n_corner} "
                  f"corners, max abs err {float(diff.max()):.3e}, max rel err {rel:.3e}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (event span, median of 20); "
                  f"device kernel {fmt_ms(dev_ms[-1])}, plain {fmt_ms(plain_dev_ms[-1])} "
                  f"(profiler, mean of 20)")

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
    if launches != 4 * pipe.n_processed:
        fail(f"detect kernel launched {launches} times, expected 4 x {pipe.n_processed}")

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

    phase(f"[done] total {time.perf_counter() - t_start:.1f} s")
    dev_total = None if None in dev_ms else sum(dev_ms)
    plain_dev_total = None if None in plain_dev_ms else sum(plain_dev_ms)
    phase(json.dumps({"kernels": [{
        "name": "detect_corners",
        "route": "cuda",
        "source": "rgbdslam_v2_tpu_torch/csrc/detect_corners.cu",
        "replaces": "rgbdslam_v2_tpu/ops/pallas_detect.py:122",
        "launches": launches,
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        # one frame's 4 level calls: summed event-span medians, and summed
        # profiler device times
        "ms": ms_total,
        "plain_ms": plain_ms_total,
        "device_ms": dev_total,
        "plain_device_ms": plain_dev_total,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
