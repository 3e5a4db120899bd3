"""encode_ms.single: host ms of one GraphManager.encode call (span
encode; the program's twin of encode_host_ms).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("encode")
    return 1e3 * st["mean_s"] if st else None
