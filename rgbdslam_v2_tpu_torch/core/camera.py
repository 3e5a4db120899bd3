"""Pinhole camera model.

Port of ``rgbdslam_v2_tpu/core/camera.py`` (Intrinsics and the TUM
calibrations; the slice backprojects inline where it needs to).
"""
from __future__ import annotations

from typing import NamedTuple


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


TUM_FR1 = Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
TUM_FR2 = Intrinsics(fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480)
TUM_DEFAULT = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)

