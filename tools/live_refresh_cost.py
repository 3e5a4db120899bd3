#!/usr/bin/env python3
"""Time the host parts of one live-view refresh (SlamPipeline._live_refresh)
on seeded arrays of phase 18's size: the trajectory text, the g2o text,
the frame pane's keypoints drawn, and the two 640x480 PNG encodes. No
device is used: these are host-clock times of the writer's parts.

To compare two trees, run the copy of this script that lies in each (it
imports the port from the tree it lies in).

Usage: python3 tools/live_refresh_cost.py [--nodes 120] [--edges 1000]
         [--keypoints 600] [--repeats 5]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=120)
    ap.add_argument("--edges", type=int, default=1000)
    ap.add_argument("--keypoints", type=int, default=600)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from rgbdslam_v2_tpu_torch.graph.g2o_io import write_g2o
    from rgbdslam_v2_tpu_torch.io.png import write_png
    from rgbdslam_v2_tpu_torch.io.tum import write_trajectory
    from rgbdslam_v2_tpu_torch.io.visualization import draw_feature_flow

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (480, 640, 3), np.uint8)
    grey = (rng.random((480, 640)) * 255).astype(np.uint8)
    uv = (rng.random((args.keypoints, 2)) * [640, 480]).astype(np.float32)
    valid = np.ones(args.keypoints, bool)
    n, m = args.nodes, args.edges
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, 3] = rng.random((n, 3))
    info = np.tile(np.eye(6, dtype=np.float32), (m, 1, 1))
    edges = [(int(rng.integers(0, n)), int(rng.integers(0, n)), poses[e % n], info[e])
             for e in range(m)]
    out = Path(tempfile.mkdtemp(prefix="live_cost_"))
    pane = draw_feature_flow(rgb, uv, uv, valid)
    parts = {
        "trajectory": lambda: write_trajectory(out / "e.txt", np.arange(n) / 30.0, poses),
        "g2o": lambda: write_g2o(out / "g.g2o", poses, [0], edges),
        "draw": lambda: draw_feature_flow(rgb, uv, uv, valid),
        "png_frame": lambda: write_png(out / "f.png", pane),
        "png_depth": lambda: write_png(out / "d.png", np.repeat(grey[..., None], 3, -1)),
    }
    ms = {}
    for name, fn in parts.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            fn()
        ms[name] = (time.perf_counter() - t0) / args.repeats * 1e3
    print(json.dumps({"ms": ms, "total_ms": sum(ms.values()), "nodes": n, "edges": m,
                      "keypoints": args.keypoints}))


if __name__ == "__main__":
    main()
