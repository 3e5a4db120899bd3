"""lockstep_host_ms: host ms of one MultiSequenceSlam.add_frames call
(a benchmark span)."""


def read(rec):
    return rec.mean_ms("add_frames")
