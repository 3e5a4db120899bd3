"""lm_iters_per_opt: LM iterations an online GraphManager.optimize ran,
over the window (the manager's counters online_lm_iterations over
online_optimizes, summed over the window's pipelines). The host-decision
path reads the convergence flag and stops early; the keep-all path runs
every iteration. None where the program has no such counters."""


def read(rec):
    n = rec.counters.get("online_optimizes")
    return rec.counters["online_lm_iterations"] / n if n else None
