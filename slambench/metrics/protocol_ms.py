"""protocol_ms: host ms of one SlamPipeline.evaluation_protocol
call (span protocol): the 5-level protocol's optimizes, prunes and
trajectory writes (with optimize.blocking, the program's twin of
final_opt_ms).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("protocol")
    return 1e3 * st["mean_s"] if st else None
