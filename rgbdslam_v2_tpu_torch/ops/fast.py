"""Dense FAST-9/16 + Harris detection and grid keypoint selection.

Port of ``rgbdslam_v2_tpu/ops/fast.py`` (``fast_score``, ``detect_corners``
with Harris ranking, ``select_keypoints_grid``). ``detect_corners`` is the
plain version behind the hand-written CUDA kernel (``ops/detect.py``).

``jax.lax.top_k`` returns the lowest index first among equal values; score
maps are mostly -inf, so ties are the common case. Every top-k here is a
stable descending sort, sliced.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .image import harris_response, maxpool2d_same

# Bresenham circle of radius 3 (the FAST-16 ring), (dy, dx), clockwise.
RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def fast_score(img: torch.Tensor, threshold: float = 0.08) -> torch.Tensor:
    """FAST-9/16 segment test: (H, W) bool corner mask."""
    H, W = img.shape
    pad = 3
    p = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    ring = torch.stack(
        [p[pad + dy : pad + dy + H, pad + dx : pad + dx + W] for dy, dx in RING.tolist()]
    )
    center = img[None]
    bright = ring > center + threshold
    dark = ring < center - threshold

    def has_arc(m):
        r2 = m & torch.roll(m, -1, 0)
        r4 = r2 & torch.roll(r2, -2, 0)
        r8 = r4 & torch.roll(r4, -4, 0)
        r9 = r8 & torch.roll(m, -8, 0)
        return r9.any(dim=0)

    return has_arc(bright) | has_arc(dark)


def detect_corners(img: torch.Tensor, threshold: float = 0.08,
                   border: int = 16) -> torch.Tensor:
    """FAST mask + Harris score + 3x3 NMS + border (the JAX
    ``detect_corners(use_harris=True)``): (H, W) score map, -inf at
    non-keypoints."""
    corner = fast_score(img, threshold)
    score = harris_response(img)
    neg = float("-inf")
    masked = torch.where(corner, score, neg)
    is_max = masked >= maxpool2d_same(masked, 3)
    out = torch.where(corner & is_max, score, neg)
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    in_border = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    return torch.where(in_border, out, neg)


def topk_stable(x: torch.Tensor, k: int, dim: int = -1):
    """lax.top_k semantics: descending, lowest index first among ties."""
    val, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return val.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def select_keypoints_grid(score_map: torch.Tensor, max_keypoints: int,
                          grid: int = 4, per_cell_factor: float = 2.0):
    """Per-cell top-k, then global top-k. Returns (uv (K, 2) [x, y],
    score (K,), valid (K,) bool)."""
    H, W = score_map.shape
    K = max_keypoints
    if grid <= 1:
        val, idx = topk_stable(score_map.reshape(-1), K)
        uv = torch.stack([(idx % W).float(), (idx // W).float()], -1)
        return uv, val, torch.isfinite(val)
    gh = -(-H // grid) * grid
    gw = -(-W // grid) * grid
    pad = F.pad(score_map, (0, gw - W, 0, gh - H), value=float("-inf"))
    ch, cw = gh // grid, gw // grid
    cells = pad.reshape(grid, ch, grid, cw).permute(0, 2, 1, 3).reshape(grid * grid, ch * cw)
    k_cell = min(ch * cw, max(1, int(per_cell_factor * K / (grid * grid))))
    cval, cidx = topk_stable(cells, k_cell)
    gidx = torch.arange(grid * grid, device=score_map.device)
    gy = (gidx // grid)[:, None]
    gx = (gidx % grid)[:, None]
    y = (gy * ch + cidx // cw).reshape(-1)
    x = (gx * cw + cidx % cw).reshape(-1)
    val, sel = topk_stable(cval.reshape(-1), K)
    uv = torch.stack([x[sel].float(), y[sel].float()], -1)
    return uv, val, torch.isfinite(val)
