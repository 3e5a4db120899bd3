"""step_queued_ms: host ms after one lockstep frame's step is launched in
MultiSequenceSlam._lockstep_shard (span step.queued, a call): the
summaries' copy to the host and every sequence's bookkeeping
(GraphManager._frames_queued).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("step.queued")
    return 1e3 * st["mean_s"] if st else None
