"""pose_landed_ms: the median ms from when the program takes a frame (its
encode's start in SlamPipeline._run_frames, else the call that hands it
in) to the moment the host learns its node's pose (its summary's
apply_summary at a drain): latency pose_landed, over its newest samples.

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""
import statistics


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    xs = stats.get("pose_landed", {}).get("latencies_s")
    return 1e3 * statistics.median(xs) if xs else None
