"""add_frames_ms: host ms of one MultiSequenceSlam.add_frames call
(span add_frames; the program's twin of lockstep_host_ms).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("add_frames")
    return 1e3 * st["mean_s"] if st else None
