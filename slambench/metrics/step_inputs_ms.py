"""step_inputs_ms: host ms of one call of GraphManager._frame_inputs
(span step.inputs): a step's candidate selection, edge slots and input
packing.

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("step.inputs")
    return 1e3 * st["mean_s"] if st else None
