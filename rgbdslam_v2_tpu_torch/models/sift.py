"""Multi-octave SIFT extractor: the SIFT / SIFTGPU feature family.

Port of ``rgbdslam_v2_tpu/models/sift.py::SiftExtractor``: 3 octaves of a
Gaussian scale space, dense DoG extrema, a top-k a octave (budget
``max(32, K >> o)``), orientation and 128-float descriptor at the
keypoint's own scale, a global top-K over detected keypoints with depth,
RootSIFT (``squareroot_descriptor_space``) and backprojection. The same
``Keypoints`` contract as ``OrbExtractor``; the descriptors are float32,
matched by squared L2 (``ops/matching.descriptor_distances``).

The JAX version describes every keypoint at every interior scale of its
octave and then keeps the keypoint's own scale. Here each keypoint reads
its own scale's gradient plane and constants, so it is described once
(a third of the work) with the same arithmetic. Every top-k is
``ops/fast.topk_stable``: the score volumes are mostly -inf, and ties break
by lowest index as ``jax.lax.top_k`` does (ROADMAP F2). No step reads a
value back to the host and every shape is static, so the extractor runs
inside a captured CUDA graph.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.camera import Intrinsics
from ..ops import sift as sift_ops
from ..ops.fast import topk_stable
from ..ops.image import resize_bilinear
from .orb import _recip32
from .types import Keypoints


@dataclasses.dataclass
class SiftExtractor:
    max_keypoints: int = 600
    n_octaves: int = 3
    n_scales: int = 3
    sigma0: float = 1.6
    contrast_threshold: float = 0.015
    edge_ratio: float = 10.0
    use_root_sift: bool = True
    require_depth: bool = True

    def octave_budget(self, octave: int) -> int:
        return max(32, self.max_keypoints // (2**octave))

    def __call__(self, gray: torch.Tensor, depth_min: torch.Tensor,
                 cam: Intrinsics) -> Keypoints:
        """gray (H, W) float32 in [0, 1]; depth_min (H, W) feature depth,
        +inf where unusable."""
        H, W = gray.shape
        dev = gray.device
        K = self.max_keypoints
        all_uv, all_score, all_theta, all_desc, all_level = [], [], [], [], []
        img_o = gray
        for o in range(self.n_octaves):
            if o > 0:
                img_o = resize_bilinear(img_o, (img_o.shape[0] // 2, img_o.shape[1] // 2))
            gs, sigmas = sift_ops.scale_space(img_o, self.n_scales, self.sigma0)
            dogs = gs[1:] - gs[:-1]
            score = sift_ops.dog_extrema(dogs, self.contrast_threshold, self.edge_ratio)
            n_s, h, w = score.shape
            k_o = self.octave_budget(o)
            val, idx = topk_stable(score.reshape(-1), k_o)
            sidx = idx // (h * w)
            yx = idx % (h * w)
            uv_o = torch.stack([(yx % w).float(), (yx // w).float()], -1)
            # each keypoint on its own scale's gradient plane (gs[s + 1])
            mag, ang = sift_ops.gradients(gs[1 : n_s + 1])
            scales = tuple(float(s) for s in sigmas[1 : n_s + 1])
            theta_o = sift_ops.keypoint_orientation_sift(mag, ang, uv_o, scales, sidx)
            desc_o = sift_ops.sift_descriptors(mag, ang, uv_o, theta_o, scales, sidx)
            all_uv.append(uv_o * float(2**o))
            all_score.append(val)
            all_theta.append(theta_o)
            all_desc.append(desc_o)
            all_level.append(torch.full((k_o,), o, dtype=torch.int32, device=dev))
        uv = torch.cat(all_uv, 0)
        score = torch.cat(all_score, 0)
        theta = torch.cat(all_theta, 0)
        desc = torch.cat(all_desc, 0)
        level = torch.cat(all_level, 0)

        xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, W - 1)
        yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, H - 1)
        z = depth_min[yi, xi]
        detected = torch.isfinite(score)
        if self.require_depth:
            detected = detected & torch.isfinite(z) & (z > 0)
        sel = torch.where(detected, score, float("-inf"))
        top_score, top_idx = topk_stable(sel, K)
        uv = uv[top_idx]
        theta = theta[top_idx]
        desc = desc[top_idx]
        level = level[top_idx]
        valid = torch.isfinite(top_score)
        z = torch.where(valid, z[top_idx], 0.0)
        if self.use_root_sift:
            desc = sift_ops.root_sift(desc)
        desc = torch.where(valid[:, None], desc, 0.0)
        x = (uv[:, 0] - cam.cx) * z * _recip32(cam.fx)
        y = (uv[:, 1] - cam.cy) * z * _recip32(cam.fy)
        xyz = torch.stack([x, y, z], dim=-1)
        return Keypoints(uv=uv, xyz=xyz, score=top_score, theta=theta, desc=desc,
                         valid=valid, level=level)

