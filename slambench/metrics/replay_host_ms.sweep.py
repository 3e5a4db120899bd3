"""replay_host_ms.sweep: host ms of one CUDA-graph replay call of the step
(graph/device_step.CapturedSteps: replay_s / replays over the window,
summed over shards)."""


def read(rec):
    n = rec.counters.get("replays")
    return 1e3 * rec.counters["replay_s"] / n if n else None
