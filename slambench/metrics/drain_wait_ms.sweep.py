"""drain_wait_ms.sweep: host ms a landed sequence-frame that the
drains waited for the card (span drain.wait: a copy's event; its total
over the pose_landed count; 0 where no drain waited).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    landed = stats.get("pose_landed", {}).get("count")
    return 1e3 * stats.get("drain.wait", {}).get("total_s", 0.0) / landed if landed else None
