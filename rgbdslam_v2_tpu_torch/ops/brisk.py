"""BRISK binary descriptors of 32x32 patches.

Port of ``rgbdslam_v2_tpu/ops/brisk.py``: the 60-point concentric-ring
pattern with per-ring smoothing (``PATTERN_XY``, ``PATTERN_SIGMA``), the
512 shortest pairs (``SHORT_I``/``SHORT_J``), the long-pair gradient
coefficients (``GRAD_CX``/``GRAD_CY``), the Gaussian footprints of every
sample for every one of the 30 orientation bins (``build_footprints``,
the JAX ``FOOTPRINTS``) and ``describe_patches_brisk``. They are built in numpy, copied here (the JAX
module imports jax).

Description is one (K, 1024) @ (1024, 30 x 60) float32 matmul of the raw
patches (TF32 off, ROADMAP F4), two dot products for the orientation, and
the 512 comparisons on the samples of the keypoint's bin, read with a
gather (the JAX version's one-hot einsum picks the same values exactly).
``describe_with_footprints`` is shared with ``ops/freak.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import backend

PATCH = 32
_PC = 15.0  # patch center (as ops/orb.py extract_patches)
N_ORIENT_BINS = 30
BRISK_BITS = 512
N_LONG = 400

_RING_R = [0.0, 3.2, 5.6, 8.4, 11.8]
_RING_N = [1, 10, 14, 15, 20]


def _build_pattern():
    pts, sig = [], []
    for r, n in zip(_RING_R, _RING_N):
        if n == 1:
            pts.append((0.0, 0.0))
            sig.append(0.7)
            continue
        spacing = 2.0 * np.pi * r / n
        s = max(0.7, 0.45 * spacing)
        for k in range(n):
            a = 2.0 * np.pi * k / n + (0.5 * np.pi * r)  # stagger rings
            pts.append((r * np.cos(a), r * np.sin(a)))
            sig.append(s)
    return np.asarray(pts, np.float32), np.asarray(sig, np.float32)


PATTERN_XY, PATTERN_SIGMA = _build_pattern()
N_SAMPLES = PATTERN_XY.shape[0]
assert N_SAMPLES == 60

# shortest 512 pairs -> descriptor bits; longest 400 -> orientation
_ii, _jj = np.triu_indices(N_SAMPLES, k=1)
_pair_d = np.linalg.norm(PATTERN_XY[_ii] - PATTERN_XY[_jj], axis=1)
_order = np.argsort(_pair_d, kind="stable")
SHORT_I = _ii[_order[:BRISK_BITS]].astype(np.int32)
SHORT_J = _jj[_order[:BRISK_BITS]].astype(np.int32)
_long_sel = _order[-N_LONG:]


def _build_grad_coeffs():
    """(60,) x2: g = sum_long (v_j - v_i) * d_ij / |d|^2 is linear in the
    sample values v."""
    cgx = np.zeros(N_SAMPLES, np.float32)
    cgy = np.zeros(N_SAMPLES, np.float32)
    for p in _long_sel:
        i, j = _ii[p], _jj[p]
        d = PATTERN_XY[j] - PATTERN_XY[i]
        d2 = float(d @ d)
        cgx[j] += d[0] / d2
        cgx[i] -= d[0] / d2
        cgy[j] += d[1] / d2
        cgy[i] -= d[1] / d2
    return cgx / N_LONG, cgy / N_LONG


GRAD_CX, GRAD_CY = _build_grad_coeffs()


def build_footprints(pattern_xy: np.ndarray, pattern_sigma: np.ndarray) -> np.ndarray:
    """(1024, 30 * S): column (b, k) is the normalized Gaussian footprint of
    pattern point k rotated by bin angle b over the 32x32 patch."""
    S = pattern_xy.shape[0]
    yy, xx = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
    F = np.zeros((PATCH * PATCH, N_ORIENT_BINS, S), np.float32)
    for b in range(N_ORIENT_BINS):
        th = 2.0 * np.pi * b / N_ORIENT_BINS
        c, s = np.cos(th), np.sin(th)
        rx = c * pattern_xy[:, 0] - s * pattern_xy[:, 1] + _PC
        ry = s * pattern_xy[:, 0] + c * pattern_xy[:, 1] + _PC
        d2 = (xx.reshape(-1, 1) - rx[None, :]) ** 2 + (yy.reshape(-1, 1) - ry[None, :]) ** 2
        g = np.exp(-d2 / (2.0 * pattern_sigma[None, :] ** 2))
        g /= np.maximum(g.sum(axis=0, keepdims=True), 1e-9)  # renormalize clip
        F[:, b, :] = g
    # XLA flushes subnormal floats to zero; the Gaussian tails hold many,
    # which also slow a CPU matmul ~20x
    F[F < np.finfo(np.float32).tiny] = 0.0
    return F.reshape(PATCH * PATCH, N_ORIENT_BINS * S)


def describe_with_footprints(patches: torch.Tensor, name: str, build, oriented: bool):
    """(K, 32, 32) raw patches -> (theta (K,), desc (K, 512) int8 +/-1) for
    a footprint family: build() -> (footprints, grad_cx, grad_cy, pair_i,
    pair_j), made once per device under `name`."""
    K = patches.shape[0]
    dev = patches.device
    fp, cgx, cgy, pi, pj = (backend.constant((name, i), lambda i=i: build()[i], dev)
                            for i in range(5))
    S = cgx.shape[0]
    vals = (patches.reshape(K, PATCH * PATCH) @ fp).reshape(K, N_ORIENT_BINS, S)
    v0 = vals[:, 0, :]  # the unrotated samples give the orientation
    theta = torch.atan2(v0 @ cgy, v0 @ cgx)
    if not oriented:
        theta = torch.zeros_like(theta)
    step = 2.0 * np.pi / N_ORIENT_BINS
    bins = torch.remainder(torch.round(theta / step).long(), N_ORIENT_BINS)
    sel = torch.gather(vals, 1, bins[:, None, None].expand(K, 1, S))[:, 0]  # (K, S)
    one = torch.ones((), dtype=torch.int8, device=dev)
    desc = torch.where(sel[:, pj] > sel[:, pi], one, -one)
    return theta, desc


@functools.lru_cache(maxsize=1)
def _brisk_constants():
    return (build_footprints(PATTERN_XY, PATTERN_SIGMA), GRAD_CX, GRAD_CY,
            SHORT_I.astype(np.int64), SHORT_J.astype(np.int64))


def describe_patches_brisk(patches: torch.Tensor, oriented: bool = True):
    """(K, 32, 32) RAW (unblurred) patches -> (theta (K,), desc (K, 512)
    int8 +/-1). The pattern smooths through its footprints, so the patches
    come from the unsmoothed level image."""
    return describe_with_footprints(patches, "brisk", _brisk_constants, oriented)
