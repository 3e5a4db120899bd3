"""online_opt_host_ms.sweep: host ms of one online
MultiSequenceSlam.optimize call (span optimize.online): its drain and the
S LM loops in turn (the program's twin of online_opt_ms).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("optimize.online")
    return 1e3 * st["mean_s"] if st else None
