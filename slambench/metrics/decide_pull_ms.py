"""decide_pull_ms: host ms a compared frame of the host-decision path
waits for its comparison's one device-to-host copy (span decide.pull in
GraphManager._add_frame_host): the frame's wait for the card.

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("decide.pull")
    return 1e3 * st["mean_s"] if st else None
