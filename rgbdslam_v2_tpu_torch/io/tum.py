"""TUM RGB-D trajectory I/O.

Port of ``rgbdslam_v2_tpu/io/tum.py``: ``associate`` (greedy closest-pair
timestamp association) and ``write_trajectory`` (one
"stamp tx ty tz qx qy qz qw" line per pose).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core import se3


def associate(a_stamps: Sequence[float], b_stamps: Sequence[float],
              max_difference: float = 0.02, offset: float = 0.0) -> List[Tuple[int, int]]:
    """Greedy best-first pairing of two timestamp lists; index pairs."""
    bs = sorted(enumerate(b_stamps), key=lambda kv: kv[1])
    b_times = [t for _, t in bs]
    candidates = []
    for ia, ta in enumerate(a_stamps):
        lo = int(np.searchsorted(b_times, ta + offset - max_difference))
        hi = int(np.searchsorted(b_times, ta + offset + max_difference, side="right"))
        for k in range(lo, hi):
            ib, tb = bs[k]
            candidates.append((abs(ta + offset - tb), ia, ib))
    candidates.sort()
    used_a, used_b, out = set(), set(), []
    for _, ia, ib in candidates:
        if ia not in used_a and ib not in used_b:
            used_a.add(ia)
            used_b.add(ib)
            out.append((ia, ib))
    out.sort()
    return out


def write_trajectory(path, stamps: Sequence[float], poses, comment: str = "") -> None:
    """TUM-format trajectory; poses (N, 4, 4) world_T_cam."""
    t, q = se3.pose_to_tum(torch.as_tensor(np.asarray(poses), dtype=torch.float32))
    t, q = t.numpy(), q.numpy()
    lines = [f"# {comment}"] if comment else []
    for i, ts in enumerate(stamps):
        lines.append(f"{ts:.6f} " + " ".join(f"{x:.7f}" for x in t[i])
                     + " " + " ".join(f"{x:.7f}" for x in q[i]))
    Path(path).write_text("\n".join(lines) + "\n")
