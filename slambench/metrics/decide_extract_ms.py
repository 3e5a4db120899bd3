"""decide_extract_ms: host ms of one host-decision frame's extraction
(span decide.extract in GraphManager._add_frame_host: the wire's decode,
the pyramid and the features, launched and, where the extractor reads
the card, waited for).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("decide.extract")
    return 1e3 * st["mean_s"] if st else None
