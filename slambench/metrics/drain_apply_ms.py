"""drain_apply_ms: host ms a landed frame in the drains' apply_summary
loops (span drain.apply: its total over the pose_landed count).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    landed = stats.get("pose_landed", {}).get("count")
    return 1e3 * stats.get("drain.apply", {}).get("total_s", 0.0) / landed if landed else None
