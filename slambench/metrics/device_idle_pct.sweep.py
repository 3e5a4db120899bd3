"""device_idle_pct.sweep: the share of the traced segment's host-clock
window in which no device activity ran (1 - the union of the
activities' intervals over the window)."""


def read(rec):
    p = rec.profile
    if p is None or not p.window_s or not p.busy_s:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
