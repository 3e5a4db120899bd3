#!/usr/bin/env python3
"""Time the default configuration (default_params(), the host-decision
path with the online PCG optimize of every node) on the first frames of
chip_smoke.py's bench sequence: fps over the frames after 20 warm-up
frames, and the median, min and max host ms of one synchronized online
optimize. It imports the port from the tree it lies in: to compare two
commits, unpack the other with git archive into a git-ignored directory
(e.g. results/parent), copy this file into its tools/, and run both
copies in one chip call, alternating.

Usage: python3 tools/default_path_fps.py [--frames 120]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import WARMUP, WORLD_SEED, render_bench
    from rgbdslam_v2_tpu_torch.config import default_params
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    if not torch.cuda.is_available():
        sys.exit("default_path_fps: needs a CUDA device")
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    poses, rgbs, depths, stamps = render_bench(world, args.frames, "cuda")
    pipe = SlamPipeline(TUM_DEFAULT, default_params(), device="cuda")
    mgr = pipe.manager
    online, times = mgr.optimize, []

    def timed_optimize(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = online(*a, **kw)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        return out

    mgr.optimize = timed_optimize
    pipe.run_arrays(rgbs[:WARMUP], depths[:WARMUP], stamps[:WARMUP], gt_poses=poses)
    torch.cuda.synchronize()
    times.clear()
    t0 = time.perf_counter()
    pipe.run_arrays(rgbs[WARMUP:], depths[WARMUP:], stamps[WARMUP:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = args.frames - WARMUP
    print(f"{ROOT.name}: {n / dt:.2f} fps over {n} frames; online optimize median "
          f"{statistics.median(times):.2f} ms (min {min(times):.2f}, max {max(times):.2f}) "
          f"over {len(times)} calls; nodes {mgr.n_nodes} [{torch.cuda.get_device_name(0)}]",
          flush=True)


if __name__ == "__main__":
    main()
