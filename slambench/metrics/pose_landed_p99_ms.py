"""pose_landed_p99_ms: the 99th percentile of pose_landed in ms (see
pose_landed_ms), over its newest samples (statistics.quantiles, exclusive
method; ~2,900 frames a run leave about 30 beyond it).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""
import statistics


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    xs = stats.get("pose_landed", {}).get("latencies_s")
    return 1e3 * statistics.quantiles(xs, n=100)[98] if xs and len(xs) > 1 else None
