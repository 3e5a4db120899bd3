#!/usr/bin/env python3
"""When should PCG read its converged flag? Masking against sparse checks,
timed on one CUDA card.

Usage: python3 tools/pcg_done_check.py [--frames 300] [--every 25] [--rounds 3]

The port's PCG loop (optim/pose_graph._pcg) freezes a converged state by
masking, as the JAX scan does, and never reads the flag. Reading it would
let the loop stop early, at the price of one host sync a read; the result
is the same, since a frozen state never changes. This script runs the
default configuration (chip_smoke.render_bench's sequence,
default_params(), device="cuda"). Every `--every` frames it intercepts the
online optimize and, from that optimize's own starting state, times it
(3 LM iterations, 24 CG iterations, PCG; host clock around a synchronized
call) with the port's loop (k = 0, never read) and with a copy of it,
`pcg_reading_every(k)`, that reads the flag every k iterations and stops
once it is set, for k in CHECKS, in turns over `--rounds` rounds; then it
lets the real optimize run. Prints the card's name and power limit, one line per sampled
frame (graph size, LM iterations used, median ms for each k, the largest
pose difference from k = 0, which index_add_'s atomics alone make nonzero
on the card), the summed medians for each k, and for each k how many
sampled optimizes it ran faster than k = 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKS = (0, 1, 2, 4, 8)


def pcg_reading_every(k: int):
    """optim/pose_graph._pcg with a host read of the converged flag every k
    iterations, stopping once it is set."""
    import torch

    def pcg(matvec, precond, b, iters, tol=1e-6):
        x = torch.zeros_like(b)
        r = b
        z = precond(r)
        p = z
        rz = torch.sum(r * z)
        b2 = torch.sum(b * b) + 1e-30
        done = torch.zeros((), dtype=torch.bool, device=b.device)
        for it in range(iters):
            Ap = matvec(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 1e-30, rz / pAp, 0.0)
            x2 = x + alpha * p
            r2 = r - alpha * Ap
            z2 = precond(r2)
            rz2 = torch.sum(r2 * z2)
            beta = torch.where(rz > 1e-30, rz2 / rz, 0.0)
            p2 = z2 + beta * p
            done2 = done | (torch.sum(r2 * r2) <= tol * b2)
            x, r, p, rz = (torch.where(done, old, new)
                           for new, old in ((x2, x), (r2, r), (p2, p), (rz2, rz)))
            done = done2
            if (it + 1) % k == 0 and bool(done):
                break
        return x

    return pcg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("pcg_done_check: needs a CUDA device")
    from chip_smoke import WORLD_SEED, render_bench
    from rgbdslam_v2_tpu_torch.config import default_params
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld
    from rgbdslam_v2_tpu_torch.optim import pose_graph
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    poses, rgbs, depths, stamps = render_bench(world, args.frames, dev)
    pipe = SlamPipeline(TUM_DEFAULT, default_params(), device=dev)
    mgr = pipe.manager
    p = mgr.params
    online = mgr.optimize
    totals = {k: 0.0 for k in CHECKS}
    wins = {k: 0 for k in CHECKS}  # sampled optimizes where k beat "never"

    masked = pose_graph._pcg
    variants = {k: pcg_reading_every(k) if k else masked for k in CHECKS}

    def timed(g, k):
        pose_graph._pcg = variants[k]
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, n_it = pose_graph.optimize(
                g, iterations=p["online_optimizer_iterations"], huber_delta=p["huber_delta"],
                pcg_iters=24, solver="pcg", n_nodes=mgr.n_nodes, n_edges=mgr.n_edges)
            torch.cuda.synchronize()
        finally:
            pose_graph._pcg = masked
        return 1e3 * (time.perf_counter() - t), n_it

    def sampled_optimize(*a, **kw):
        if mgr.n_nodes % args.every == 0:
            with torch.inference_mode():
                mgr._apply_fixation()  # the real optimize applies the same mask
                snap = mgr.graph
                times = {k: [] for k in CHECKS}
                out = {}
                for r in range(args.rounds + 1):  # round 0 warms up
                    for k in (CHECKS if r % 2 else CHECKS[::-1]):
                        g = dataclasses.replace(snap, poses=snap.poses.clone())
                        ms, n_it = timed(g, k)
                        if r:
                            times[k].append(ms)
                        out[k] = (g.poses[: mgr.n_nodes], n_it)
            med = {k: statistics.median(v) for k, v in times.items()}
            for k in CHECKS:
                totals[k] += med[k]
                wins[k] += med[k] < med[0]
            diff = max(float((out[k][0] - out[0][0]).abs().max()) for k in CHECKS)
            print(f"[{mgr.n_nodes} nodes, {mgr.n_edges} edge slots, {out[0][1]} LM iterations] "
                  + ", ".join(f"check every {k or 'never'}: {med[k]:.3f} ms" for k in CHECKS)
                  + f"; largest pose difference from never: {diff:.2e}", flush=True)
        return online(*a, **kw)

    mgr.optimize = sampled_optimize
    pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    print("summed medians: " + ", ".join(f"check every {k or 'never'}: {totals[k]:.3f} ms"
                                         for k in CHECKS), flush=True)
    print("optimizes where reading beat never: " + ", ".join(
        f"every {k}: {wins[k]}" for k in CHECKS[1:]), flush=True)


if __name__ == "__main__":
    main()
