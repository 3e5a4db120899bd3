"""lm_iter_ms: host ms of one LM iteration of an online
GraphManager.optimize (span optimize.lm directly under optimize.online:
the iteration's launches and its convergence read, which waits for the
card on the host-decision path).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("optimize.lm", {}).get("parents", {}).get("optimize.online")
    return 1e3 * st["total_s"] / st["count"] if st else None
