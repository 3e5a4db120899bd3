"""lm_seq_ms: host ms of one sequence's LM loop inside an online
MultiSequenceSlam.optimize (span optimize.seq under optimize.online; the
protocol's blocking loops, with more iterations and a convergence read,
left out), so that online_opt_host_ms.sweep over S of them shows the
online call's drain and set-up.

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    st = stats.get("optimize.seq", {}).get("parents", {}).get("optimize.online")
    return 1e3 * st["total_s"] / st["count"] if st else None
