"""fps: frames completed in the window over its host-clock seconds,
sequence ends included (drivers/serial.py)."""


def read(rec):
    return rec.frames / rec.window_s if rec.window_s else None
