#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase 6 (bench.py's make_pipe configuration on
the 520-frame bench sequence, rendered on the card) several times in one
process: per run fps, graph statistics, CUDA graph replays and the host
time of a replay call, synchronizing calls in replayed groups, peak
memory and the protocol's ATE L0..L4. The drains are pipelined, so which
summaries have landed when a frame picks its candidates depends on timing:
the runs show the spread that makes.

Usage: python3 tools/bench_config_runs.py [--runs 3] [--frames 520]
                                          [--set name=value ...]

--set changes one of make_pipe's parameters for every run (true/false,
numbers and strings), to see which of them moves a result.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=520)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    args = ap.parse_args()
    over = {}
    for item in args.set:
        name, value = item.split("=", 1)
        over[name] = {"true": True, "false": False}.get(value.lower(), value)
        for kind in (int, float):
            try:
                over[name] = kind(value)
                break
            except ValueError:
                pass
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import WORLD_SEED, bench_config_run, render_bench
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld

    if not torch.cuda.is_available():
        sys.exit("bench_config_runs: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), "| make_pipe with", over or "no change")
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    poses, rgbs, depths, stamps = render_bench(world, args.frames, "cuda")
    fps, l4 = [], []
    for r in range(args.runs):
        b = bench_config_run(poses, rgbs, depths, stamps, torch.device("cuda"), **over)
        st = b["stats"]
        fps.append(b["fps"])
        l4.append(b["ate"][4])
        print(f"run {r}: {b['fps']:.2f} fps ({b['ms_per_frame']:.2f} ms/frame); nodes "
              f"{st['nodes']}, active edges {st['active_edges']} ({st['loop_edges']} loop, "
              f"{b['const_edges']} constant-position), keyframes {st['keyframes']}; replays "
              f"{b['replays']} at {b['replay_host_ms']:.3f} ms host a call; syncs in replayed "
              f"groups {b['replay_syncs']}; encode {b['encode_ms']:.3f} ms/frame; peak "
              f"{b['peak_gib']:.2f} GiB; ATE L0..L4 "
              f"{' / '.join(f'{a:.4f}' for a in b['ate'])} m", flush=True)
        torch.cuda.empty_cache()
    print(f"fps median {statistics.median(fps):.2f} (min {min(fps):.2f}, max {max(fps):.2f}); "
          f"ATE L4 median {statistics.median(l4):.4f} (min {min(l4):.4f}, max {max(l4):.4f}) m")


if __name__ == "__main__":
    main()
