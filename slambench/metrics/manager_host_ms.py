"""manager_host_ms: host ms a frame inside the pipeline's own calls over
the window (SlamPipeline.wall_time / n_processed, summed over the
window's pipelines)."""


def read(rec):
    n = rec.counters.get("manager_frames")
    return 1e3 * rec.counters["manager_wall_s"] / n if n else None
