"""decide_host_ms: host ms a compared frame of the host-decision path
spends deciding on the host and committing the node (spans decide.host
and decide.commit in GraphManager._add_frame_host, summed, over the
compared frames; a dropped frame has no commit).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    host = stats.get("decide.host")
    if not host:
        return None
    commit = stats.get("decide.commit", {}).get("total_s", 0.0)
    return 1e3 * (host["total_s"] + commit) / host["count"]
