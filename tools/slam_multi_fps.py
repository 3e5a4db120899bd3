#!/usr/bin/env python3
"""Time parallel/slam_multi.MultiSequenceSlam with make_pipe's parameters
(chip_smoke.multi_params), optimized online every optimizer_skip_step
frames as the slam-multi CLI does, in a process of its own, on lockstep
frames saved as .npy files: wires.npy (T, S, L) u8 from
MultiSequenceSlam.compact, stamps.npy (T,) and gt0.npy (S, 4, 4), the
first frames' poses.

The first WARMUP lockstep frames run untimed (the eager first step and the
capture among them); the frames after them, except the last --profile
frames, are timed on the host clock between two synchronizations; the last
--profile frames run under torch.profiler (device activities only): the
device-busy ms a lockstep frame (the union of the activities' intervals),
its share of the window's wall time and the device activities a frame.
Prints one JSON line.

chip_smoke.py phase 17 saves its 8 encoded sequences and runs it, and
tools/make_pipe_fps.py on sequence 0's frames for the single-sequence fps.

Usage: python3 tools/slam_multi_fps.py FRAMES_DIR [--profile N]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "slambench"))
    from chip_smoke import MULTI_PROFILE_FRAMES, WARMUP, multi_params
    from lib.trace import union_s

    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir")
    ap.add_argument("--profile", type=int, default=MULTI_PROFILE_FRAMES)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.parallel.slam_multi import MultiSequenceSlam

    if not torch.cuda.is_available():
        sys.exit("slam_multi_fps: no CUDA card")
    d = Path(args.frames_dir)
    wires, stamps, gt0 = (np.load(d / f"{k}.npy") for k in ("wires", "stamps", "gt0"))
    T, S = wires.shape[:2]
    p = multi_params()
    ms = MultiSequenceSlam(TUM_DEFAULT, S, params=p)

    def lockstep(k):
        ms.add_frames(wires[k], np.full(S, stamps[k]), gt_poses=gt0 if k == 0 else None)
        if (k + 1) % p["optimizer_skip_step"] == 0:  # the slam-multi CLI's schedule
            ms.optimize(iterations=p["online_optimizer_iterations"], blocking=False)

    for k in range(WARMUP):
        lockstep(k)
    n_prof = min(args.profile, T - WARMUP - 1)
    end = T - n_prof
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(WARMUP, end):
        lockstep(k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        for k in range(end, T):
            lockstep(k)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - tp)
    acts = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = union_s((e.time_range.start, e.time_range.end) for e in acts) / 1e3 if acts else None
    print(json.dumps({
        "sequences": S, "frames_timed": end - WARMUP,
        "lockstep_fps": (end - WARMUP) / dt, "sequence_frames_per_s": S * (end - WARMUP) / dt,
        "profile_frames": n_prof,
        "device_ms": None if busy is None else busy / n_prof,
        "busy_share": None if busy is None else busy / wall_ms,
        "wall_ms": wall_ms / n_prof, "device_ops": len(acts) / n_prof,
        "stats": ms.statistics()[0]}))


if __name__ == "__main__":
    main()
