"""step_bringup_ms: host ms a landed frame in bringing up the step's
CUDA graphs (spans step.eager and step.capture: a key's first, eager call
and its capture, in every new SlamPipeline; their total over the
pose_landed count).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    landed = stats.get("pose_landed", {}).get("count")
    spans = [stats[k] for k in ("step.eager", "step.capture") if k in stats]
    return 1e3 * sum(st["total_s"] for st in spans) / landed if spans and landed else None
