#!/usr/bin/env python3
"""The JAX package's visual odometry (parallel/multi_eval.py) on
chip_smoke.py phase 17's sequences, on the CPU: the reference of phase 17's
vo-multi bound.

Renders each of the MULTI_S sequences (world MULTI_WORLD_SEED0 + s, orbit
MULTI_ORBIT_SEED0 + s, 640x480, MULTI_FRAMES frames, depth without noise
quantized to 1/5000 m as phase 17 renders it) with the JAX package's
renderer, and runs the JAX package's per-sequence VO chain with
VO_MULTI's settings and the key jax.random.split(PRNGKey(seed), S)[s]
(what vo_trajectories_sharded gives sequence s), one sequence at a time to
bound memory. Prints each sequence's L0 (ATE of the VO trajectory against
the ground truth) and one JSON line with the list.

Usage: JAX_PLATFORMS=cpu python3 tools/vo_multi_jax_reference.py [--frames N]
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import MULTI_FRAMES, MULTI_ORBIT_SEED0, MULTI_S, MULTI_WORLD_SEED0, VO_MULTI

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=MULTI_FRAMES)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from rgbdslam_v2_tpu.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu.eval.ate import evaluate_ate
    from rgbdslam_v2_tpu.io import SyntheticWorld, render_sequence
    from rgbdslam_v2_tpu.models.orb import OrbExtractor
    from rgbdslam_v2_tpu.parallel.multi_eval import _vo_one_sequence

    kw = dict(VO_MULTI)
    seed = kw.pop("seed")
    ext = OrbExtractor(max_keypoints=kw.pop("max_keypoints"))
    run = jax.jit(functools.partial(_vo_one_sequence, extractor=ext, cam=TUM_DEFAULT, **kw))
    keys = jax.random.split(jax.random.PRNGKey(seed), MULTI_S)
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    l0 = []
    for s in range(MULTI_S):
        t0 = time.perf_counter()
        world = SyntheticWorld.create(seed=MULTI_WORLD_SEED0 + s, cam=TUM_DEFAULT)
        poses, rgbs, depths = render_sequence(world, args.frames, seed=MULTI_ORBIT_SEED0 + s)
        d16 = np.clip(np.asarray(depths) * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
        grays = (np.asarray(rgbs, np.float32) @ luma) / 255.0
        dm = d16.astype(np.float32) / 5000.0
        est, _, ok = run(grays, dm, dm > 0, keys[s])
        est = np.asarray(est)
        stamps = np.arange(args.frames) / 30.0
        l0.append(float(evaluate_ate(stamps, est[:, :3, 3], stamps,
                                     np.asarray(poses)[:, :3, 3]).rmse))
        print(f"sequence {s}: L0 {l0[-1]:.4f} m, RANSAC ok {float(np.mean(ok)):.3f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"vo_l0_jax": l0, "frames": args.frames}))


if __name__ == "__main__":
    main()
