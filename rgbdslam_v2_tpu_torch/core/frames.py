"""Frame containers: fixed-shape RGB-D frames.

Port of ``rgbdslam_v2_tpu/core/frames.py`` (``Frame``, ``rgb_to_gray``,
``make_frame``): a frame is a NamedTuple of tensors with validity masks in
place of the reference's NaN points (src/node.h:154-208). Timestamps stay
on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import Intrinsics, backproject_grid


class Frame(NamedTuple):
    """gray (H, W) float32 in [0, 1]; rgb (H, W, 3) uint8 (zeros for a grey
    input); depth (H, W) float32 meters, 0 where invalid; points (H, W, 3)
    float32 camera-frame xyz (z = 0 where invalid); valid (H, W) bool."""

    gray: torch.Tensor
    rgb: torch.Tensor
    depth: torch.Tensor
    points: torch.Tensor
    valid: torch.Tensor


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, 3) -> float32 (H, W) in [0, 1] (ITU-R BT.601 luma)."""
    r, g, b = (rgb[..., c].to(torch.float32) for c in range(3))
    return (0.299 * r + 0.587 * g + 0.114 * b) * (1.0 / 255.0)


def make_frame(rgb, depth, cam: Intrinsics, min_depth: float = 0.1,
               max_depth: float = 10.0) -> Frame:
    """A Frame from rgb uint8 (H, W, 3) (or a grey image) and depth (H, W)
    meters, as tensors or arrays (arrays land on the CPU); depth outside
    (min_depth, max_depth) or not finite is invalid (src/misc.cpp:480-520)."""
    rgb = torch.as_tensor(rgb)
    depth = torch.as_tensor(depth).to(torch.float32)
    valid = torch.isfinite(depth) & (depth > min_depth) & (depth < max_depth)
    depth = torch.where(valid, depth, 0.0)
    return Frame(
        gray=rgb_to_gray(rgb) if rgb.ndim == 3 else rgb.to(torch.float32),
        rgb=rgb if rgb.ndim == 3 else torch.zeros(depth.shape + (3,), dtype=torch.uint8,
                                                  device=depth.device),
        depth=depth, points=backproject_grid(depth, cam), valid=valid)
