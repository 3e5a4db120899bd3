"""setup_s: host-clock seconds from the start of the process to the
window: imports, the kernels' build or load, rendering, the program's
construction and the warm-up frames."""


def read(rec):
    return rec.setup_s
