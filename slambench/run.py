#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root: renders the cell's sequences from the seed,
builds and warms the program (set-up), runs the cell's traffic for
`--seconds` seconds (the window), reads the program's answers back and
judges them against the plain reference in ``slambench/reference/``, and
prints one JSON line last: the end-to-end metrics (``--trace 0``) or the
per-layer metrics with the device's busy time and a breakdown of the
trace (``--trace 1``). Without a CUDA card it exits non-zero and prints no
result. The pieces are found by name (``lib/spec.py``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from lib import env  # noqa: E402
from lib.env import log  # noqa: E402

env.set_cache_dirs()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device: str = "cuda", t_start: float = T_START, cell: dict = None) -> dict:
    """One run; returns the result line's object (printed by main). The
    CPU tests call it with device="cpu" and a cell cut to a tiny size."""
    from lib import judge, spec, trace as tracing
    from lib.record import Record

    cell = cell or spec.cell(args.workload)
    trace = bool(args.trace)
    if device != "cpu":
        env.require_cards(cell["chips"])
    import torch

    import rgbdslam_v2_tpu_torch  # noqa: F401  (fails here in a checkout without the program)

    rec = Record(trace)
    drv = spec.driver(cell["traffic_data"]).Driver(cell, args.seed, rec, device=device)
    drv.setup()
    if trace:
        drv.trace_segment()
    rec.setup_s = time.perf_counter() - t_start
    log(f"set-up {rec.setup_s:.1f} s")
    rec.spans.clear()  # the window's spans only
    drv.window(args.seconds)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    log(f"window {rec.window_s:.1f} s, {rec.frames} frames")
    snaps = drv.close()
    del drv
    t0 = time.perf_counter()
    numbers = judge.judge(snaps, cell["config_data"], args.seed, device=device)
    log(f"reference {time.perf_counter() - t0:.1f} s")
    ok, rows = judge.verdict(numbers, cell["limits"])
    metrics = {}
    for m in spec.cell_metrics(args.workload, trace):
        v = spec.metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": rec.frames,
           "failed": 0 if ok else rec.frames, "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile.busy_s
        dev["window_s"] = rec.profile.window_s
        out["breakdown"] = tracing.breakdown(rec.profile)
    out["info"] = {"frames": rec.frames, "window_s": rec.window_s,
                   "spans": {k: [len(v), sum(v)] for k, v in rec.spans.items()},
                   "ate_l4_m": rec.values.get("ate_l4_m"),
                   **{k: v for k, v in numbers.items() if k not in cell["limits"]["limits"]}}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def main() -> int:
    args = parse()
    if not (HERE.parent / "rgbdslam_v2_tpu_torch").is_dir():
        sys.exit("slambench: the program (rgbdslam_v2_tpu_torch) is not in this checkout")
    log(env.card_line())
    out = run(args)
    bad = env.forbidden_modules()
    if bad:
        sys.exit(f"slambench: the process loaded {', '.join(bad)}; no result")
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
