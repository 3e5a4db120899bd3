#!/usr/bin/env python3
"""Profile the PyTorch port's per-frame step on one CUDA card.

Usage: python3 tools/profile_torch_port.py [--frames 120] [--window 40]
                                           [--config keepall|make_pipe]

Renders the bench sequence on the card and runs a keep-all configuration
taken from chip_smoke.py (render_bench; bench_params, one frame a step, or
make_pipe_params, bench.py's own: ydct, 4 frames a step as CUDA graphs),
and traces a steady window of frames, fed through run_arrays, with
torch.profiler: prints the device-busy share of the window (union of
kernel intervals over wall time), the top operators by device time and by
host time, and per-frame figures. Outside the profiler it also times the
host encode of the window's frames and one online optimize (3 LM
iterations) of the graph as it stands after the window.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def busy_ms(events) -> float:
    """Union length of the device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--window", type=int, default=40)
    ap.add_argument("--config", choices=("keepall", "make_pipe"), default="keepall")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import WORLD_SEED, bench_params, make_pipe_params, render_bench
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    poses, rgbs, depths, stamps = render_bench(world, args.frames, "cuda")
    params = bench_params() if args.config == "keepall" else make_pipe_params()
    pipe = SlamPipeline(TUM_DEFAULT, params, device="cuda")
    n0 = args.frames - args.window
    pipe.run_arrays(rgbs[:n0], depths[:n0], stamps[:n0], gt_poses=poses)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_arrays(rgbs[n0:], depths[n0:], stamps[n0:])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = busy_ms(kernels)
    print(f"window: {args.window} frames, {wall_ms / args.window:.3f} ms/frame wall, "
          f"device busy {busy / args.window:.3f} ms/frame ({100 * busy / wall_ms:.1f}% of wall), "
          f"{len(kernels) / args.window:.0f} device ops/frame "
          f"[{torch.cuda.get_device_name(0)}]")
    t0 = time.perf_counter()
    for i in range(n0, args.frames):
        pipe.manager.encode(rgbs[i], depths[i])
    enc_ms = 1e3 * (time.perf_counter() - t0) / args.window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.manager.optimize(iterations=3, blocking=True)
    torch.cuda.synchronize()
    print(f"host {pipe.manager.ingest_fmt} encode {enc_ms:.3f} ms/frame; one online optimize (3 LM iterations, "
          f"{pipe.manager.n_nodes} nodes, {pipe.manager.n_edges} edge slots) "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=25))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=20))


if __name__ == "__main__":
    main()
