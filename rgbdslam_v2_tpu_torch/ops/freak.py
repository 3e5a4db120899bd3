"""FREAK binary descriptors of 32x32 patches.

Port of ``rgbdslam_v2_tpu/ops/freak.py``: the 43-field retinal pattern
(``PATTERN_XY``, ``PATTERN_SIGMA``), the 512 coarse-to-fine pairs
(``PAIR_I``/``PAIR_J``), the symmetric-pair gradient coefficients
(``GRAD_CX``/``GRAD_CY``) and ``describe_patches_freak``. They are built in
numpy, copied here (the JAX module imports jax); description is
``ops/brisk.describe_with_footprints`` with these constants.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .brisk import build_footprints, describe_with_footprints

FREAK_BITS = 512

# center + 7 rings x 6 fields; radius and sigma shrink toward the fovea
_N_RINGS = 7
_R_OUT, _R_IN = 13.0, 1.5
_RING_R = [0.0] + [
    _R_OUT * (_R_IN / _R_OUT) ** (k / (_N_RINGS - 1)) for k in range(_N_RINGS)
][::-1]  # inner -> outer after the center


def _build_pattern():
    pts, sig, ring, ang = [], [], [], []
    for k, r in enumerate(_RING_R):
        if r == 0.0:
            pts.append((0.0, 0.0))
            sig.append(0.6)
            ring.append(k)
            ang.append(0.0)
            continue
        s = max(0.6, 0.38 * r)  # field size ~ eccentricity
        for j in range(6):
            a = np.pi / 3.0 * j + (np.pi / 6.0) * (k % 2)  # stagger rings
            pts.append((r * np.cos(a), r * np.sin(a)))
            sig.append(s)
            ring.append(k)
            ang.append(a)
    return (np.asarray(pts, np.float32), np.asarray(sig, np.float32),
            np.asarray(ring, np.int32), np.asarray(ang, np.float32))


PATTERN_XY, PATTERN_SIGMA, _RING_ID, _ANGLE = _build_pattern()
N_FIELDS = PATTERN_XY.shape[0]
assert N_FIELDS == 43

# coarse-to-fine: descending combined field size, then descending
# separation; the first 512 of the 903 candidate pairs
_ii, _jj = np.triu_indices(N_FIELDS, k=1)
_size = PATTERN_SIGMA[_ii] + PATTERN_SIGMA[_jj]
_dist = np.linalg.norm(PATTERN_XY[_ii] - PATTERN_XY[_jj], axis=1)
_order = np.lexsort((-_dist, -_size))
PAIR_I = _ii[_order[:FREAK_BITS]].astype(np.int32)
PAIR_J = _jj[_order[:FREAK_BITS]].astype(np.int32)


def _build_grad_coeffs():
    """Orientation from symmetric pairs (within-ring opposites and
    same-spoke opposites of consecutive staggered rings), folded into two
    (43,) coefficient vectors."""
    pairs = []
    for a in range(N_FIELDS):
        for b in range(a + 1, N_FIELDS):
            if _RING_ID[a] != _RING_ID[b] and abs(int(_RING_ID[a]) - int(_RING_ID[b])) != 1:
                continue
            if _RING_ID[a] == 0 or _RING_ID[b] == 0:
                continue
            da = (_ANGLE[a] - _ANGLE[b]) % (2.0 * np.pi)
            tol = 1e-3 if _RING_ID[a] == _RING_ID[b] else np.pi / 6.0 + 1e-3
            if min(da, 2.0 * np.pi - da) > np.pi - tol:  # ~opposite
                pairs.append((a, b))
    cgx = np.zeros(N_FIELDS, np.float32)
    cgy = np.zeros(N_FIELDS, np.float32)
    for a, b in pairs:
        d = PATTERN_XY[b] - PATTERN_XY[a]
        n = float(np.linalg.norm(d))
        cgx[b] += d[0] / n
        cgx[a] -= d[0] / n
        cgy[b] += d[1] / n
        cgy[a] -= d[1] / n
    return cgx / max(len(pairs), 1), cgy / max(len(pairs), 1)


GRAD_CX, GRAD_CY = _build_grad_coeffs()


@functools.lru_cache(maxsize=1)
def _freak_constants():
    return (build_footprints(PATTERN_XY, PATTERN_SIGMA), GRAD_CX, GRAD_CY,
            PAIR_I.astype(np.int64), PAIR_J.astype(np.int64))


def describe_patches_freak(patches: torch.Tensor, oriented: bool = True):
    """(K, 32, 32) RAW (unblurred) patches -> (theta (K,), desc (K, 512)
    int8 +/-1). The retina smooths through its footprints, so the patches
    come from the unsmoothed level image."""
    return describe_with_footprints(patches, "freak", _freak_constants, oriented)
