"""Pinhole camera model.

Port of ``rgbdslam_v2_tpu/core/camera.py`` (Intrinsics, the TUM
calibrations, ``backproject``, ``pixel_grid`` and ``backproject_grid``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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



def backproject(u, v, z, cam: Intrinsics) -> torch.Tensor:
    """Pixel (u, v) and depth z -> camera-frame xyz (..., 3)."""
    x = (u - cam.cx) * z / cam.fx
    y = (v - cam.cy) * z / cam.fy
    return torch.stack([x, y, z.expand_as(x)], dim=-1)


def pixel_grid(cam: Intrinsics, device=None, dtype=torch.float32):
    """(H, W) grids of the u and v pixel coordinates."""
    v = torch.arange(cam.height, dtype=dtype, device=device)[:, None]
    u = torch.arange(cam.width, dtype=dtype, device=device)[None, :]
    return u.expand(cam.height, cam.width), v.expand(cam.height, cam.width)


def backproject_grid(depth: torch.Tensor, cam: Intrinsics) -> torch.Tensor:
    """Dense depth (..., H, W) -> organized camera-frame points (..., H, W,
    3); invalid depths (<= 0 or not finite) give z = 0 points."""
    u, v = pixel_grid(cam, depth.device, depth.dtype)
    z = torch.where(torch.isfinite(depth) & (depth > 0), depth, 0.0)
    return backproject(u, v, z, cam)
