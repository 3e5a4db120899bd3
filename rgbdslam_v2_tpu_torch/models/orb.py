"""Multi-scale ORB extractor.

Port of ``rgbdslam_v2_tpu/models/orb.py``: ``OrbExtractor.__call__``
(4-level bilinear pyramid, FAST+Harris+NMS per level, per-cell top-k,
32x32 patch description on the blurred level image, global top-K merge,
backprojection), ``min_depth_map`` and ``feature_depth_map``. The
``descriptor`` field picks the binary family as in the JAX version:
steered BRIEF (256 bits, ORB's), or BRISK / FREAK (512 bits,
``ops/brisk.py`` / ``ops/freak.py``), which describe the raw, unblurred
level image through their own smoothing footprints.

The level images are built first, each resized from level 0 straight into
the detect kernel's level layout (rows padded to 4 floats where the width
needs it, ``ops/detect.pitched_empty``); one
``ops/detect.detect_pyramid`` call then scores every level: one launch of
the hand-written CUDA kernel for a CUDA image (the JAX package runs its
Pallas kernel per level on a TPU), the plain torch version level by level
for a CPU image. ``fast_threshold`` is a run-time argument of the kernel, so
the manager's adaptive detector changes it without a rebuild.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.camera import Intrinsics
from ..ops import brisk, detect, fast as fast_ops, freak, orb as orb_ops
from ..ops.image import gaussian_blur, resize_bilinear
from .types import Keypoints


@dataclasses.dataclass
class OrbExtractor:
    """Configured ORB pipeline; call with (gray, depth_map, cam)."""

    max_keypoints: int = 600
    n_levels: int = 4
    scale_factor: float = 1.2
    fast_threshold: float = 0.06
    grid: int = 4
    # oriented=False: plain (un-steered) BRIEF, theta reported as 0
    oriented: bool = True
    # "brief" (steered BRIEF, 256 bits), "brisk" or "freak" (512 bits)
    descriptor: str = "brief"

    @property
    def desc_bits(self) -> int:
        return 512 if self.descriptor in ("brisk", "freak") else 256

    def level_shapes(self, H: int, W: int) -> List[Tuple[int, int]]:
        out = []
        for lvl in range(self.n_levels):
            s = self.scale_factor**lvl
            out.append((max(32, int(round(H / s))), max(32, int(round(W / s)))))
        return out

    def level_budget(self, level: int) -> int:
        inv = [self.scale_factor**-lvl for lvl in range(self.n_levels)]
        return max(16, int(math.ceil(self.max_keypoints * inv[level] / sum(inv))))

    def pyramid(self, gray: torch.Tensor) -> List[torch.Tensor]:
        """The level images in the detect kernel's level layout: level 0 is
        `gray` (copied only if its layout does not fit), level l its bilinear
        resize to level_shapes[l], written straight into padded rows."""
        H, W = gray.shape
        images = [detect.as_level(gray)]
        for h, w in self.level_shapes(H, W)[1:]:
            images.append(resize_bilinear(gray, (h, w),
                                          out=detect.pitched_empty(h, w, gray.device)))
        return images

    def __call__(self, gray: torch.Tensor, depth_min: torch.Tensor,
                 cam: Intrinsics) -> Keypoints:
        """gray (H, W) float32 in [0, 1]; depth_min (H, W) feature depth,
        +inf where unusable."""
        H, W = gray.shape
        dev = gray.device
        images = self.pyramid(gray)
        score_maps = detect.detect_pyramid(images, self.fast_threshold)
        all_uv, all_score, all_level, all_theta, all_desc = [], [], [], [], []
        for lvl, (img_l, score_map) in enumerate(zip(images, score_maps)):
            k_l = self.level_budget(lvl)
            uv, sc, _ = fast_ops.select_keypoints_grid(score_map, k_l, grid=self.grid)
            if self.descriptor == "brief":
                patches = orb_ops.extract_patches(gaussian_blur(img_l, 2.0), uv)
                theta_l, desc_l = orb_ops.describe_patches(patches, self.oriented)
            else:
                describe = (brisk.describe_patches_brisk if self.descriptor == "brisk"
                            else freak.describe_patches_freak)
                theta_l, desc_l = describe(orb_ops.extract_patches(img_l, uv), self.oriented)
            all_uv.append(uv * (self.scale_factor**lvl))
            all_score.append(sc)
            all_level.append(torch.full((k_l,), lvl, dtype=torch.int32, device=dev))
            all_theta.append(theta_l)
            all_desc.append(desc_l)
        uv = torch.cat(all_uv, 0)
        score = torch.cat(all_score, 0)
        level = torch.cat(all_level, 0)
        theta_all = torch.cat(all_theta, 0)
        desc_all = torch.cat(all_desc, 0)

        xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, W - 1)
        yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, H - 1)
        z = depth_min[yi, xi]
        has_depth = torch.isfinite(z) & (z > 0)
        detected = torch.isfinite(score)
        sel_score = torch.where(detected & has_depth, score, float("-inf"))

        top_score, top_idx = fast_ops.topk_stable(sel_score, self.max_keypoints)
        uv = uv[top_idx]
        level = level[top_idx]
        valid = torch.isfinite(top_score)
        z = torch.where(valid, z[top_idx], 0.0)
        theta = theta_all[top_idx]
        desc = desc_all[top_idx] * valid[:, None]
        # XLA compiles a division by a constant as a product with its float32
        # reciprocal; the same order gives the reference's bits
        x = (uv[:, 0] - cam.cx) * z * _recip32(cam.fx)
        y = (uv[:, 1] - cam.cy) * z * _recip32(cam.fy)
        xyz = torch.stack([x, y, z], dim=-1)
        return Keypoints(uv=uv, xyz=xyz, score=top_score, theta=theta, desc=desc,
                         valid=valid, level=level)


def _recip32(v: float) -> float:
    """1/v rounded to float32 (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(v))


def min_depth_map(depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """3x3 min-pool of depth with invalid -> +inf."""
    d = torch.where(valid, depth, float("inf"))
    return -F.max_pool2d(-d[None, None], 3, stride=1, padding=1)[0, 0]


def feature_depth_map(depth: torch.Tensor, valid: torch.Tensor, use_min: bool):
    """Depth plane sampled at keypoints (+inf where unusable): the center
    pixel (reference default) or the 3x3 minimum."""
    if use_min:
        return min_depth_map(depth, valid)
    return torch.where(valid, depth, float("inf"))
