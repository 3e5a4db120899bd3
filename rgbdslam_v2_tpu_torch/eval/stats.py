"""Paired significance test over per-sequence results.

Port of ``rgbdslam_v2_tpu/eval/stats.py`` (``PairedComparison``,
``wilcoxon_compare``: scipy's Wilcoxon signed-rank test over paired ATE
results, as the reference's evaluation figures run it).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class PairedComparison(NamedTuple):
    """Configuration A against B over paired sequences."""

    n: int  # usable pairs (ties dropped)
    median_diff: float  # median(a - b); negative = A better (lower ATE)
    statistic: float  # Wilcoxon W
    p_value: float
    significant: bool  # p < alpha


def wilcoxon_compare(ate_a: Sequence[float], ate_b: Sequence[float],
                     alpha: float = 0.05) -> PairedComparison:
    """Paired Wilcoxon signed-rank test (zero differences dropped); n = 0
    and p = 1 when every pair ties."""
    from scipy.stats import wilcoxon

    a = np.asarray(ate_a, float)
    b = np.asarray(ate_b, float)
    if a.shape != b.shape:
        raise ValueError("paired comparison needs equal-length results")
    diff = a - b
    nz = diff[diff != 0]
    if len(nz) < 1:
        return PairedComparison(0, 0.0, 0.0, 1.0, False)
    stat, p = wilcoxon(a, b, zero_method="wilcox")
    return PairedComparison(n=int(len(nz)), median_diff=float(np.median(diff)),
                            statistic=float(stat), p_value=float(p),
                            significant=bool(p < alpha))
