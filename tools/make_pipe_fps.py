#!/usr/bin/env python3
"""Time bench.py's make_pipe configuration (chip_smoke.make_pipe_params)
on frames saved as .npy files, in a process of its own: 20 warm-up frames
one at a time, a blocking optimize, then the rest through run_arrays,
timed on the host clock between two synchronizations. Prints one JSON line
with the fps, the frames timed, the statistics and the retrievals run.

chip_smoke.py phase 16 saves the bench frames (poses, rgbs, depths,
stamps) into a directory and runs this script once a configuration, so
that each fps comes from a clean process.

Usage: python3 tools/make_pipe_fps.py FRAMES_DIR [--set name=value ...]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import WARMUP, make_pipe_params
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    if not torch.cuda.is_available():
        sys.exit("make_pipe_fps: no CUDA card")
    over = {}
    for item in args.set:
        name, _, value = item.partition("=")
        try:
            over[name] = json.loads(value)
        except ValueError:
            over[name] = value
    d = Path(args.frames_dir)
    poses, rgbs, depths, stamps = (np.load(d / f"{k}.npy", mmap_mode="r")
                                   for k in ("poses", "rgbs", "depths", "stamps"))
    pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(**over), device="cuda")
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
    mgr = pipe.manager
    print(json.dumps(dict(fps=(len(rgbs) - WARMUP) / dt, frames=len(rgbs) - WARMUP,
                          stats=mgr.statistics(), retrievals=mgr.retrievals,
                          retrieval_hits=mgr.retrieval_hits, set=over)), flush=True)


if __name__ == "__main__":
    main()
