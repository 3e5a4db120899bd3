"""online_opt_ms: host ms of one online MultiSequenceSlam.optimize call,
its S LM loops one after another (a benchmark span)."""


def read(rec):
    return rec.mean_ms("online_opt")
