"""extract_device_ms: device ms of one extractor call (the wire's decode,
the pyramid and the feature family's extraction, GraphManager._extract) on
the cell's frames: the summed durations of the device activities of a
profiler trace of the calls, after the window."""


def read(rec):
    return rec.values.get("extract_device_ms")
