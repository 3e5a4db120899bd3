"""sweep_fps: sequence-frames completed in the window over its host-clock
seconds, round ends included (drivers/lockstep.py)."""


def read(rec):
    return rec.frames / rec.window_s if rec.window_s else None
