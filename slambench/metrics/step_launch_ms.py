"""step_launch_ms: host ms a landed frame in the step's launch calls
(span step.launch: its total less its longest call, over the pose_landed
count): the CUDA-graph replay calls (whose total is replay_s) and the
eager step calls of single frames. The longest call is left out: the
first eager call carries the step's one-time start-up (in a checkout's
first run the kernels' nvcc build too).

The program's own aggregates (rgbdslam_v2_tpu_torch.utils.timing) over
the whole process less what ran under the profiler: set-up and close
included. None where the program has no spans."""


def read(rec):
    from rgbdslam_v2_tpu_torch.utils import timing

    stats = getattr(timing, "span_stats", dict)()
    landed = stats.get("pose_landed", {}).get("count")
    st = stats.get("step.launch")
    return 1e3 * (st["total_s"] - st["max_s"]) / landed if st and landed else None
