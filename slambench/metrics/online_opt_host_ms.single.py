"""online_opt_host_ms.single: host ms of one online
GraphManager.optimize call (span optimize.online), its drain included.

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("optimize.online")
    return 1e3 * st["mean_s"] if st else None
