#!/usr/bin/env python3
"""The default configuration's protocol ATE at a small size, JAX package
against the PyTorch port, both on the CPU.

Usage: python3 tools/default_path_ate.py [--frames 300] [--only jax|torch]

default_params() unchanged for both packages, on the bench sequence's
trajectory (synthetic world seed 0, orbit seed 2, depth noise 0.01 z^2 with
1/5000 m quantization, as chip_smoke.render_bench) rendered by the JAX
renderer at 160x120 (the parity tests' scale). Prints, per package, the
run time, the graph statistics, dropped frames and the 5-level protocol's
ATE L0..L4. chip_smoke.py's phase 5 takes its ATE bound from the JAX
package's L4 here (x 1.5) because the default configuration drifts over
hundreds of frames: its 8 candidate slots are all taken by 4 predecessors
and 4 geodesic neighbours, so no keyframe is sampled at random and no loop
closes.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--only", choices=("jax", "torch"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from rgbdslam_v2_tpu.config import default_params as jax_default_params
    from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics
    from rgbdslam_v2_tpu.io import SyntheticWorld, render_sequence
    from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline
    from rgbdslam_v2_tpu_torch.config import default_params
    from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    world = SyntheticWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = render_sequence(world, args.frames, seed=2, depth_noise_sigma=0.01)
    poses = np.asarray(poses)
    depths = np.clip(np.asarray(depths) * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    stamps = np.arange(args.frames) / 30.0
    makers = {
        "jax": lambda: JPipeline(JIntrinsics(*CAM), jax_default_params()),
        "torch": lambda: SlamPipeline(Intrinsics(*CAM), default_params(), device="cpu"),
    }
    for name in [args.only] if args.only else ["jax", "torch"]:
        pipe = makers[name]()
        t0 = time.perf_counter()
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        run_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as td:
            rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
        ate = " / ".join(f"{rep.ate_rmse[k]:.4f}" for k in range(5))
        print(f"{name}: {args.frames} frames at 160x120 on the CPU in {run_s:.1f} s; "
              f"{pipe.manager.statistics()}; dropped {pipe.n_dropped}; "
              f"ATE L0..L4 {ate} m", flush=True)


if __name__ == "__main__":
    main()
