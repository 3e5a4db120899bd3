"""decide_compare_ms: host ms a compared frame of the host-decision path
to select its candidates and launch their comparison (spans
decide.select and decide.compare in GraphManager._add_frame_host,
summed, over the compared frames).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    sel, cmp = stats.get("decide.select"), stats.get("decide.compare")
    if not (sel and cmp):
        return None
    return 1e3 * (sel["total_s"] + cmp["total_s"]) / cmp["count"]
