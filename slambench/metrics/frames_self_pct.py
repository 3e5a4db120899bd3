"""frames_self_pct: the share of the pipeline's frame calls (span frames:
SlamPipeline.process_frame and _process_group, the time wall_time sums)
that no span inside them explains: its self time over its total, in %.

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("frames")
    return 100.0 * st["self_s"] / st["total_s"] if st and st["total_s"] > 0 else None
