"""The yardstick of the kernels: the card's peaks and each kernel's
operations and bytes, computed from the shapes it runs at.

A frozen copy of the arithmetic of the port's ``chip_smoke.py`` (constants
``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``, ``FP64_OPS_PER_S``,
``DETECT_OPS_PER_PX``, ``KABSCH_OPS_PER_PROBLEM``,
``REFINE_FIT_OPS_PER_MATCH``, ``REFINE_GATE_OPS_PER_MATCH``; phase 2's
detect and refine bounds) and of the pyramid shapes of
``rgbdslam_v2_tpu_torch/models/orb.py`` (``OrbExtractor.level_shapes``).
Peaks are NVIDIA's data-sheet figures for the H100 SXM at its 700 W limit;
every run prints the card's name and power limit beside them.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores
FP64_OPS_PER_S = 34e12

# float operations a pixel of the detect kernel's work: Sobel 20 + products
# 3 + two 5-tap blurs of three maps 54 + Harris 7 + FAST 2 + 32 compares + NMS 9
DETECT_OPS_PER_PX = 127
# the refine kernel (double arithmetic): a weighted match in one fit's
# moment pass, a valid match in one gate, one fit's 3x3 part
REFINE_FIT_OPS_PER_MATCH = 40
REFINE_GATE_OPS_PER_MATCH = 120
KABSCH_OPS_PER_PROBLEM = 1200
# bytes a match the refine kernel reads once (src, dst, their covariances:
# 12 floats; the weight; the valid and inlier flags) and writes (its flag)
REFINE_BYTES_PER_MATCH = 55
REFINE_BYTES_PER_CANDIDATE = 2 * 64 + 8  # T in and out; n_inliers, rmse


def orb_level_shapes(H: int, W: int, n_levels: int = 4, scale: float = 1.2):
    return [(max(32, int(round(H / scale**lvl))), max(32, int(round(W / scale**lvl))))
            for lvl in range(n_levels)]


def detect_bound_s(H: int, W: int, n_levels: int = 4, scale: float = 1.2) -> float:
    """Least time of one detect launch (every level of one frame): each
    pixel read once and its score written once, or its operations."""
    px = sum(h * w for h, w in orb_level_shapes(H, W, n_levels, scale))
    return max(8.0 * px / HBM_BYTES_PER_S, DETECT_OPS_PER_PX * px / FP32_OPS_PER_S)


def refine_bound_s(B: int, M: int, iterations: int, inliers) -> float:
    """Least time of one refine launch over B candidates of M match slots,
    `iterations` refits: its bytes, or its double operations counted for
    the inlier counts the launch's candidates reached (`inliers`, B
    numbers; the valid matches the gates read are at least as many, so the
    operations are a floor)."""
    nbytes = B * (M * REFINE_BYTES_PER_MATCH + REFINE_BYTES_PER_CANDIDATE)
    ops = sum(iterations * (n * REFINE_FIT_OPS_PER_MATCH + KABSCH_OPS_PER_PROBLEM)
              + (iterations + 1) * n * REFINE_GATE_OPS_PER_MATCH for n in inliers)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S)
