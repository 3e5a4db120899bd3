#!/usr/bin/env python3
"""bench.py's make_pipe configuration on the same frames in both packages,
on the CPU: the JAX package and the PyTorch port.

Renders the first N frames of the bench sequence (synthetic room, orbit
seed 2, 640x480, depth noise 0.01 z^2 with 1/5000 m quantization) once with
the JAX package's render_sequence, as numpy arrays, and feeds the same
arrays to rgbdslam_v2_tpu.pipeline.SlamPipeline and to the port's
SlamPipeline(device="cpu"), both with make_pipe's parameters
(bench.py:170-207; the port's copy is chip_smoke.make_pipe_params) and
driven as bench.py drives them: 20 warm-up frames one at a time, a blocking
optimize, the rest through run_arrays, then the 5-level evaluation
protocol. For each RANSAC seed (tpu_seed) it prints, for each package, the
protocol's ATE L0..L4, the accepted sequential and loop edges and the node
count, and the port's L4 and accepted edges against the JAX package's (the
north star's test: L4 within 1.25x, accepted edges within 25%).

The two packages draw their RANSAC samples from different generators
(jax.random, torch.Generator), so they are compared as two draws of one
configuration, not frame by frame. Their pipelined drains also land at
different times on the CPU: the port's staged copies are done when staged,
while the JAX package's arrays, dispatched asynchronously, may still report
is_ready() false, so its staged batches stay unread for a while (and their
nodes below the inaffected watermark). --jax-drains-land-at-once makes
every JAX array report ready, as the port's CPU copies are.

--sequence takes another of tools/hard_sequences.py's full-scale
sequences in place of the bench orbit (low_texture, depth_holes, spin360
rendered by that tool and cut to N frames; dark_stretch rendered at N
frames and darkened from 40% to 60% of them, as chip_smoke.py phase 11
does); --icp adds use_icp=True to both packages' parameters; --config
default runs default_params() (the host-decision path) in place of
make_pipe. --family takes a feature family's settings on top of the
configuration (chip_smoke.FAMILY_PARAMS: SIFTGPU at the reference's
published evaluation settings, BRISK, FREAK; ORB adds nothing), as
chip_smoke.py phase 13 runs them; --packages runs one package only.
--set name=value (repeatable; the value read as JSON where it parses,
else as a string) sets one parameter in both packages on top of all that,
as chip_smoke.py phase 14 sets its options; --size WxH renders the orbit at
another frame size (fx = fy = 525, the principal point at the centre).

Usage: JAX_PLATFORMS=cpu python3 tools/make_pipe_same_frames.py
           [--frames 200] [--seeds 0 1] [--threads 4] [--jax-drains-land-at-once]
           [--sequence orbit] [--icp] [--config make_pipe] [--family ORB]
           [--packages jax torch] [--set name=value ...] [--size 640x480]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def drive(pipe, poses, rgbs, depths, stamps, out_dir) -> dict:
    """bench.py's feeding order, then the protocol."""
    from chip_smoke import WARMUP

    t0 = time.perf_counter()
    for i in range(WARMUP):
        pipe.process_frame(rgbs[i], depths[i], float(stamps[i]),
                           gt_pose=poses[0] if i == 0 else None)
    pipe.manager.optimize(blocking=True)
    pipe.params.set("skip_first_n_frames", WARMUP)
    pipe.run_arrays(rgbs, depths, stamps)
    run_s = time.perf_counter() - t0
    rep = pipe.evaluation_protocol(out_dir, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
    st = pipe.manager.statistics()
    return dict(ate=[rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)],
                seq=st["sequential_edges"], loop=st["loop_edges"], nodes=st["nodes"],
                run_s=run_s)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--jax-drains-land-at-once", action="store_true")
    ap.add_argument("--sequence", default="orbit",
                    choices=("orbit", "dark_stretch", "low_texture", "depth_holes", "spin360"))
    ap.add_argument("--icp", action="store_true")
    ap.add_argument("--config", default="make_pipe", choices=("make_pipe", "default"))
    ap.add_argument("--family", default="ORB", choices=("ORB", "SIFTGPU", "BRISK", "FREAK"))
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"], choices=("jax", "torch"))
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--size", default="640x480")
    args = ap.parse_args()
    overrides = {}
    for item in args.set:
        name, _, value = item.partition("=")
        try:
            overrides[name] = json.loads(value)
        except ValueError:
            overrides[name] = value
    W, H = (int(v) for v in args.size.split("x"))
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    torch.set_num_threads(args.threads)
    from chip_smoke import FAMILY_PARAMS, MAKE_PIPE, WORLD_SEED
    from rgbdslam_v2_tpu.config import ParameterServer as JParams
    from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics
    from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence
    from rgbdslam_v2_tpu.ops import dct_wire as jdw
    from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline
    from rgbdslam_v2_tpu_torch.core.camera import Intrinsics

    cam = (525.0, 525.0, (W - 1) / 2.0, (H - 1) / 2.0, W, H)
    J_TUM = JIntrinsics(*cam)
    from rgbdslam_v2_tpu_torch.config import ParameterServer
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    t0 = time.perf_counter()
    if args.sequence == "orbit":
        world = JWorld.create(seed=WORLD_SEED, cam=J_TUM)
        orbit = world.orbit_trajectory(args.frames, seed=2)  # bench.py's, cut to N
        poses, rgbs, depths = render_sequence(world, args.frames, seed=2,
                                              depth_noise_sigma=0.01, trajectory=orbit)
    elif args.sequence == "dark_stretch":
        from rgbdslam_v2_tpu_torch.io.synthetic import dark_stretch

        poses, rgbs, depths = render_sequence(JWorld.create(seed=7, cam=J_TUM), args.frames,
                                              seed=8, depth_noise_sigma=0.01)
        rgbs = dark_stretch(np.asarray(rgbs))[0]
    else:
        sys.path.insert(0, str(ROOT / "tools"))
        from hard_sequences import build_sequences

        poses, rgbs, depths, _ = build_sequences(J_TUM, small=False,
                                                 with_fr2=False)[args.sequence]()
        poses, rgbs, depths = poses[: args.frames], rgbs[: args.frames], depths[: args.frames]
        args.frames = len(rgbs)
    poses = np.asarray(poses)
    depths = np.clip(np.asarray(depths) * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    rgbs = np.asarray(rgbs)
    stamps = np.arange(args.frames) / 30.0
    print(f"rendered {args.frames} frames {W}x{H} of {args.sequence} with the JAX package in "
          f"{time.perf_counter() - t0:.1f} s (CPU)", flush=True)

    if args.jax_drains_land_at_once:
        type(jnp.zeros(1)).is_ready = lambda self: True
    for seed in args.seeds:
        res = {}
        for name in args.packages:
            params = dict(MAKE_PIPE if args.config == "make_pipe" else {}, tpu_seed=seed,
                          **({"use_icp": True} if args.icp else {}),
                          **FAMILY_PARAMS.get(args.family, {}), **overrides)
            if name == "jax":  # defaults, then the configuration's values
                quality = jdw.QUALITY
                pipe = JPipeline(J_TUM, JParams(params))
            else:
                pipe = SlamPipeline(Intrinsics(*cam), ParameterServer(params), device="cpu")
            with tempfile.TemporaryDirectory() as td:
                res[name] = drive(pipe, poses, rgbs, depths, stamps, td)
            if name == "jax":
                jdw.set_quality(quality)
            r = res[name]
            ate = " / ".join(f"{a:.4f}" for a in r["ate"])
            print(f"seed {seed} {name:5s} {args.family} {overrides or ''}: ATE L0..L4 {ate} "
                  f"m; accepted edges {r['seq']} sequential + {r['loop']} loop; nodes "
                  f"{r['nodes']}; run {r['run_s']:.0f} s (CPU)", flush=True)
            del pipe
        if len(res) < 2:
            continue
        j, t = res["jax"], res["torch"]
        acc_j, acc_t = j["seq"] + j["loop"], t["seq"] + t["loop"]
        l4_ratio = t["ate"][4] / j["ate"][4]
        acc_diff = (acc_t - acc_j) / acc_j
        verdict = "diverges" if l4_ratio > 1.25 or abs(acc_diff) > 0.25 else "does not diverge"
        print(f"seed {seed}: port L4 / JAX L4 = {l4_ratio:.3f}; accepted edges port vs JAX "
              f"{acc_t} vs {acc_j} ({100 * acc_diff:+.1f}%): the port {verdict}", flush=True)


if __name__ == "__main__":
    main()
