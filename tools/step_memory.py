#!/usr/bin/env python3
"""Device memory of the keep-all step by feature family, on one CUDA card.

For each family (ORB, SIFTGPU at chip_smoke.FAMILY_PARAMS, BRISK) on
bench.py's make_pipe configuration: the extractor's peak over one 640x480
frame called eagerly, then the pipeline's own path (20 warm-up frames one
at a time, then 16 in groups of 4: an eager warm-up group, the capture,
replays), with the allocated, reserved and peak allocated memory after
each stage. Prints one line a stage.

Usage: python3 tools/step_memory.py [--families ORB SIFTGPU BRISK]
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gib(x: int) -> str:
    return f"{x / 2**30:.3f} GiB"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", nargs="+", default=["ORB", "SIFTGPU", "BRISK"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("step_memory: no CUDA device")
    from chip_smoke import FAMILY_PARAMS, WARMUP, WORLD_SEED, make_pipe_params, render_bench
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld
    from rgbdslam_v2_tpu_torch.models.orb import feature_depth_map
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    dev = torch.device("cuda")
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    n = WARMUP + 16
    poses, rgbs, depths, stamps = render_bench(world, n, dev)
    print(torch.cuda.get_device_name(0), flush=True)

    def stage(fam, what):
        torch.cuda.synchronize()
        print(f"{fam:8s} {what}: allocated {gib(torch.cuda.memory_allocated())}, reserved "
              f"{gib(torch.cuda.memory_reserved())}, peak allocated "
              f"{gib(torch.cuda.max_memory_allocated())}", flush=True)

    for fam in args.families:
        gc.collect()  # the previous family's pipeline is cyclic garbage
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(**FAMILY_PARAMS.get(fam, {})),
                            device=dev)
        mgr = pipe.manager
        stage(fam, "manager built (store and graph)")
        gray = (torch.from_numpy(rgbs[0]).to(dev).float()
                @ torch.tensor([0.299, 0.587, 0.114], device=dev)) / 255.0
        z = torch.from_numpy(depths[0].astype(np.float32) / 5000.0).to(dev)
        fdepth = feature_depth_map(z, z > 0, False)
        with torch.inference_mode():
            mgr.extractor(gray, fdepth, TUM_DEFAULT)
        stage(fam, "extractor once, eager")
        torch.cuda.reset_peak_memory_stats()
        for i in range(WARMUP):
            pipe.process_frame(rgbs[i], depths[i], float(stamps[i]),
                               gt_pose=poses[0] if i == 0 else None)
        stage(fam, f"{WARMUP} frames one at a time")
        sg = mgr.step_graph
        for k in range(WARMUP, n, 4):
            torch.cuda.reset_peak_memory_stats()
            before = (sg.eager_groups, sg.captures)
            pipe._process_group([mgr.encode(rgbs[i], depths[i]) for i in range(k, k + 4)],
                                [float(t) for t in stamps[k : k + 4]])
            kind = ("eager group" if sg.eager_groups > before[0] else
                    "capture" if sg.captures > before[1] else "replay")
            stage(fam, f"group of 4 at frame {k} ({kind})")
        del pipe, mgr


if __name__ == "__main__":
    main()
