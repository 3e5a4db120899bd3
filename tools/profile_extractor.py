#!/usr/bin/env python3
"""Device time of one OrbExtractor call on one CUDA card, kernel by kernel.

Usage: python3 tools/profile_extractor.py [--calls 50]

Renders the first frame of the bench sequence (chip_smoke.py's world and
seed, 640x480), makes its gray image with the ingest's luma and its feature
depth map (+inf where the depth is missing), and traces `--calls` calls of
the default extractor (ORB-600 over 4 levels) with torch.profiler. Prints
the device time a call (the summed durations of the device activities), the
device activities a call, and each kernel's device time and count a call,
then one JSON line of the same. It imports the port from the tree it lies
in, so a copy of this file in another checkout's tools/ measures that
checkout's extractor.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD_SEED = 0  # chip_smoke.WORLD_SEED


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence
    from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    _, rgbs, depths = render_sequence(world, 1, seed=2, device="cuda")
    rgb = torch.from_numpy(rgbs[0]).cuda().to(torch.int32)
    gray = ((rgb[..., 0] * 77 + rgb[..., 1] * 150 + rgb[..., 2] * 29) >> 8).float() * (1 / 255.0)
    d = torch.from_numpy(depths[0]).cuda().float()
    dmin = torch.where(d > 0, d, float("inf"))
    ex = OrbExtractor()
    with torch.inference_mode():
        for _ in range(3):
            ex(gray, dmin, TUM_DEFAULT)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                ex(gray, dmin, TUM_DEFAULT)
            torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3 / args.calls
            by_name[e.name][1] += 1
    total = sum(ms for ms, _ in by_name.values())
    n_ops = sum(n for _, n in by_name.values()) / args.calls
    print(f"extractor device time {total:.5f} ms a call, {n_ops:.1f} device activities a call "
          f"(torch.profiler, {args.calls} calls)")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in rows:
        print(f"  {ms:.5f} ms  {n / args.calls:5.1f} a call  {name[:100]}")
    print(json.dumps({"device_ms": total, "device_ops": n_ops,
                      "kernels": {name: [ms, n / args.calls] for name, (ms, n) in rows}}))


if __name__ == "__main__":
    main()
