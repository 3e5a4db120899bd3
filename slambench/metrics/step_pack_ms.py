"""step_pack_ms: host ms of one lockstep frame's packing in
MultiSequenceSlam._lockstep_shard (span step.pack, a call): every
sequence's step configuration, the pinned input buffer and the CUDA-graph
key.

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("step.pack")
    return 1e3 * st["mean_s"] if st else None
