"""final_opt_host_ms: host ms of one sequence's end, the program's twin
of final_opt_ms: a blocking optimize outside the protocol (span
optimize.blocking at the top of its thread, a call; set-up's is one of
them) and a 5-level protocol (span protocol, a call, which holds its own
blocking optimizes).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    prot = stats.get("protocol")
    if not prot:
        return None
    top = stats.get("optimize.blocking", {}).get("parents", {}).get(None)
    return 1e3 * (prot["mean_s"] + (top["total_s"] / top["count"] if top else 0.0))
