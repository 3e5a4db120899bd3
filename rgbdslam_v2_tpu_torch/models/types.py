"""Fixed-capacity keypoint set.

Port of ``rgbdslam_v2_tpu/models/types.py::Keypoints``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Keypoints(NamedTuple):
    """K keypoints: uv (K, 2) [x, y] full-res pixels, xyz (K, 3) camera
    frame (0 where invalid), score (K,) (-inf padding), theta (K,),
    desc (K, 256) int8 +/-1, valid (K,) bool, level (K,) int32."""

    uv: torch.Tensor
    xyz: torch.Tensor
    score: torch.Tensor
    theta: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    level: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)
