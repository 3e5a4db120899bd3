#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, and the
check that the control and the planted faults fail them.

    python3 slambench/control.py --workload <cell> --seeds 11 12 13 [--fault NAME] [--out FILE]

For each seed, in one process: the cell's set-up and its traffic until the
first sequence (or round) has ended, then the judge's numbers for the
program (the lower readings) and for the control: the plain reference
computed in bfloat16 in the program's place, one precision below the
float32 the configurations state (the upper readings; ``lib/judge.py``).
Each side's numbers go through the cell's limits (``lib/judge.verdict``). With ``--fault`` the
program runs with that fault planted (``faults.py``) and no control is
read. One JSON line a seed, on standard output and appended to FILE. Exits
non-zero where the control, or the planted fault, comes out correct on a
seed. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from lib import env  # noqa: E402

env.set_cache_dirs()


def readings(cell: dict, seed: int, device: str = "cuda", fault: str = None) -> dict:
    """One seed's numbers: the program's (under `fault` where given) and,
    without a fault, the control's, each with its verdict."""
    import faults
    from lib import judge, spec
    from lib.record import Record

    rec = Record(False)
    driver = cell["traffic_data"]["driver"]
    with faults.planted(fault, driver) if fault else contextlib.nullcontext():
        drv = spec.driver(cell["traffic_data"]).Driver(cell, seed, rec, device=device)
        drv.setup()
        drv.window(float("inf"), ends=1)
        snaps = drv.close()
    del drv
    gc.collect()
    t0 = time.perf_counter()
    out = judge.judge(snaps, cell["config_data"], seed, control=fault is None, device=device)
    out.update(seed=seed, window_s=rec.window_s, reference_s=time.perf_counter() - t0,
               ate_l4_m=rec.values.get("ate_l4_m"), fault=fault)
    out["correct"] = judge.verdict(out, cell["limits"])[0]
    if fault is None:
        ctl = {k[len("control."):]: v for k, v in out.items() if k.startswith("control.")}
        ctl["frames_missing"] = out["frames_missing"]
        out["control.correct"] = judge.verdict(ctl, cell["limits"])[0]
    return out


def main() -> int:
    import faults

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=faults.NAMES)
    ap.add_argument("--out")
    args = ap.parse_args()
    from lib import spec

    cell = spec.cell(args.workload)
    env.require_cards(cell["chips"])
    env.log(env.card_line())
    failed = []
    for seed in args.seeds:
        r = dict(readings(cell, seed, fault=args.fault), workload=args.workload)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        caught = not r["correct"] if args.fault else not r["control.correct"]
        if not caught:
            failed.append(seed)
    bad = env.forbidden_modules()
    if bad:
        sys.exit(f"control: the process loaded {', '.join(bad)}")
    if failed:
        what = f"the fault {args.fault}" if args.fault else "the control"
        sys.exit(f"control: {what} came out correct on seeds {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
