"""encode_host_ms: host ms of one GraphManager.encode call on the cell's
frames (a benchmark span; traced runs wrap the call)."""


def read(rec):
    return rec.mean_ms("encode")
