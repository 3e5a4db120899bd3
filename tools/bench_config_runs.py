#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase 6 (bench.py's make_pipe configuration on
the 520-frame bench sequence, rendered on the card) several times in one
process: per run fps, graph statistics, CUDA graph replays and the host
time of a replay call, synchronizing calls and waits for copies not landed
in replayed groups, peak memory and the protocol's ATE L0..L4; with
rescues, the rescued edges' errors against ground truth.

Usage: python3 tools/bench_config_runs.py [--runs 3] [--frames 520]
           [--sequence bench|spin360|low_texture|depth_holes|dark_stretch]
           [--variants shipped,at_drain,...] [--set name=value ...]

--set changes one of make_pipe's parameters for every run (true/false,
numbers and strings), to see which of them moves a result. --variants
runs each named variant once a round, the order reversed every other
round:

  shipped      the code as it is
  at_drain     every staged drain copy read at its drain, waiting for it
  when_landed  a staged copy read as soon as its event reports it landed
               (the JAX package's is_ready rule: depends on timing)
  unpipelined  tpu_drain_pipelined=False
  no_icp       use_icp=False
  unwritten    the retroactive rescue runs, but on a copy of the graph:
               its verdicts are counted, its writes discarded

--sequence takes one of chip_smoke.py's 640x480 sequences in place of the
bench orbit (the hard ones at --frames 300 as phase 11 runs them).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("shipped", "at_drain", "when_landed", "unpipelined", "no_icp", "unwritten")


def parse_sets(items) -> dict:
    over = {}
    for item in items:
        name, value = item.split("=", 1)
        over[name] = {"true": True, "false": False}.get(value.lower(), value)
        for kind in (int, float):
            try:
                over[name] = kind(value)
                break
            except ValueError:
                pass
    return over


def apply_variant(name: str, over: dict):
    """Patch the manager for variant `name`; returns (parameter changes,
    undo)."""
    from rgbdslam_v2_tpu_torch.graph import manager

    GM = manager.GraphManager
    landed, rescue = GM._landed, manager.retro_rescue

    def undo():
        GM._landed, manager.retro_rescue = landed, rescue

    if name == "at_drain":
        GM._landed = lambda self, batch: True
    elif name == "when_landed":
        GM._landed = lambda self, batch: batch[2] is None or batch[2].query()
    elif name == "unwritten":
        def unwritten(graph, *a, **k):
            copy = dataclasses.replace(graph, poses=graph.poses.clone(),
                                       edge_meas=graph.edge_meas.clone(),
                                       edge_info=graph.edge_info.clone())
            return rescue(copy, *a, **k)
        manager.retro_rescue = unwritten
    extra = {"unpipelined": {"tpu_drain_pipelined": False},
             "no_icp": {"use_icp": False}}.get(name, {})
    return dict(over, **extra), undo


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=520)
    ap.add_argument("--sequence", default="bench")
    ap.add_argument("--variants", default="shipped")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    args = ap.parse_args()
    over = parse_sets(args.set)
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        sys.exit(f"bench_config_runs: unknown variants {sorted(unknown)}")
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import (WORLD_SEED, bench_config_run, fmt_rescue_errors, render_bench,
                            render_hard, rescue_edge_errors)
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld

    if not torch.cuda.is_available():
        sys.exit("bench_config_runs: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), "| make_pipe with", over or "no change", "on", args.sequence,
          f"({args.frames} frames)")
    if args.sequence == "bench":
        world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
        seq = render_bench(world, args.frames, "cuda")
    else:
        seq = render_hard(args.sequence, args.frames, "cuda")[:4]
    fps = {v: [] for v in variants}
    ate = {v: [] for v in variants}
    for r in range(args.runs):
        for v in variants if r % 2 == 0 else variants[::-1]:
            run_over, undo = apply_variant(v, over)
            try:
                b = bench_config_run(*seq, torch.device("cuda"), keep=True, **run_over)
            finally:
                undo()
            mgr = b.pop("pipe").manager
            st = b["stats"]
            fps[v].append(b["fps"])
            ate[v].append(b["ate"])
            print(f"run {r} {v}: {b['fps']:.2f} fps ({b['ms_per_frame']:.2f} ms/frame); nodes "
                  f"{st['nodes']}, active edges {st['active_edges']} ({st['loop_edges']} loop, "
                  f"{b['const_edges']} constant-position), keyframes {st['keyframes']}, GICP "
                  f"rescues {st['icp_rescues']} of {b['rescue_items']} items; replays "
                  f"{b['replays']} at {b['replay_host_ms']:.3f} ms host a call; in replayed "
                  f"groups {b['replay_syncs']} syncs ({b['replay_pulls']} blocking drain "
                  f"copies), {b['replay_waits']} waits for a copy not landed, "
                  f"{b['replay_idle']} of them leaving the card idle ({b['copy_waits']} and "
                  f"{b['idle_waits']} in all); encode {b['encode_ms']:.3f} ms/frame "
                  f"({b['encodes']}); peak {b['peak_gib']:.2f} GiB; ATE L0..L4 "
                  f"{' / '.join(f'{a:.4f}' for a in b['ate'])} m", flush=True)
            if v != "unwritten" and st["icp_rescues"]:
                print(f"run {r} {v}: {fmt_rescue_errors(rescue_edge_errors(mgr, seq[0]))}")
            del mgr
            torch.cuda.empty_cache()
    for v in variants:
        l1 = [a[1] for a in ate[v]]
        l4 = [a[4] for a in ate[v]]
        print(f"{v}: fps median {statistics.median(fps[v]):.2f} (min {min(fps[v]):.2f}, max "
              f"{max(fps[v]):.2f}); ATE L1 {min(l1):.4f}-{max(l1):.4f}, L4 "
              f"{min(l4):.4f}-{max(l4):.4f} m")


if __name__ == "__main__":
    main()
