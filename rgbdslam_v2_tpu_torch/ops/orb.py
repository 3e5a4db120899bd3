"""ORB orientation + steered-BRIEF description of 32x32 patches.

Port of ``rgbdslam_v2_tpu/ops/orb.py``: the seeded BRIEF pattern
(``PATTERN_P``/``PATTERN_Q``), ``MOMENT_XY``, the 30-bin rotated pattern
(``_build_brief_bins``), ``extract_patches`` and ``describe_patches``.

The JAX version evaluates all 30 orientation bins as one (1024, 30*256)
+/-1 matmul (gathers are slow on a TPU). Each column of that matrix holds
one +1 cell (rotated p) and one -1 cell (rotated q), so the selected bin's
value is exactly I(p') - I(q'); here it is read with two gathers from
per-bin index tables. The sign, and so the descriptor, is the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import backend

PATCH_R = 15
DESC_BITS = 256

_rng = np.random.default_rng(1234)
_sigma = PATCH_R / 1.9
_pattern = np.clip(
    _rng.normal(0.0, _sigma, size=(DESC_BITS, 2, 2)), -(PATCH_R - 2), PATCH_R - 2
).astype(np.float32)
PATTERN_P = _pattern[:, 0]  # (256, 2) [dx, dy]
PATTERN_Q = _pattern[:, 1]

N_ORIENT_BINS = 30
PATCH = 32
_PC = 15.0

_pyy, _pxx = np.mgrid[0:PATCH, 0:PATCH]
_pdx = (_pxx - _PC).astype(np.float32)
_pdy = (_pyy - _PC).astype(np.float32)
_pmask = (_pdx**2 + _pdy**2) <= PATCH_R**2
MOMENT_XY = np.stack(
    [(_pdx * _pmask).reshape(-1), (_pdy * _pmask).reshape(-1)], axis=1
)  # (1024, 2)


def _build_brief_cells():
    """(30, 256) flat patch cells of rotated p and q for every bin."""
    p_idx = np.zeros((N_ORIENT_BINS, DESC_BITS), np.int64)
    q_idx = np.zeros((N_ORIENT_BINS, DESC_BITS), np.int64)
    for b in range(N_ORIENT_BINS):
        th = 2.0 * np.pi * b / N_ORIENT_BINS
        c, s = np.cos(th), np.sin(th)
        for pat, dst in ((PATTERN_P, p_idx), (PATTERN_Q, q_idx)):
            rx = c * pat[:, 0] - s * pat[:, 1]
            ry = s * pat[:, 0] + c * pat[:, 1]
            xi = np.clip(np.round(rx + _PC).astype(int), 0, PATCH - 1)
            yi = np.clip(np.round(ry + _PC).astype(int), 0, PATCH - 1)
            dst[b] = yi * PATCH + xi
    return p_idx, q_idx


BRIEF_P_CELLS, BRIEF_Q_CELLS = _build_brief_cells()


def extract_patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """One 32x32 patch per keypoint at round(uv), starts clipped into the
    image (lax.gather CLIP mode): (K, 32, 32)."""
    H, W = img.shape
    y0 = torch.clamp(torch.round(uv[:, 1]).long() - int(_PC), 0, H - PATCH)
    x0 = torch.clamp(torch.round(uv[:, 0]).long() - int(_PC), 0, W - PATCH)
    r = torch.arange(PATCH, device=img.device)
    yy = (y0[:, None] + r[None, :])[:, :, None]
    xx = (x0[:, None] + r[None, :])[:, None, :]
    return img[yy, xx]


def describe_patches(patches: torch.Tensor, oriented: bool = True):
    """(K, 32, 32) blurred patches -> (theta (K,), desc (K, 256) int8 +/-1)."""
    K = patches.shape[0]
    dev = patches.device
    flat = patches.reshape(K, PATCH * PATCH)
    m = flat @ backend.constant("orb_moment_xy", lambda: MOMENT_XY, dev)
    theta = torch.atan2(m[:, 1], m[:, 0])
    if not oriented:
        theta = torch.zeros_like(theta)
    step = 2.0 * np.pi / N_ORIENT_BINS
    bins = torch.remainder(torch.round(theta / step).long(), N_ORIENT_BINS)
    p_cells = backend.constant("orb_p_cells", lambda: BRIEF_P_CELLS, dev)[bins]  # (K, 256)
    q_cells = backend.constant("orb_q_cells", lambda: BRIEF_Q_CELLS, dev)[bins]
    sel = torch.gather(flat, 1, p_cells) - torch.gather(flat, 1, q_cells)
    one = torch.ones((), dtype=torch.int8, device=dev)
    desc = torch.where(sel > 0, one, -one)
    return theta, desc
