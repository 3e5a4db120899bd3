"""TUM RGB-D trajectory I/O.

Port of ``rgbdslam_v2_tpu/io/tum.py``: ``associate`` (greedy closest-pair
timestamp association), ``read_trajectory_file`` and ``rows_to_poses``
(numpy), and ``write_trajectory`` (one "stamp tx ty tz qx qy qz qw" line per
pose).
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


def read_trajectory_file(path) -> np.ndarray:
    """A TUM trajectory file -> (N, 8) float64 [stamp tx ty tz qx qy qz qw];
    comments, blank and short lines skipped, commas read as spaces."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.replace(",", " ").split()]
        if len(vals) >= 8:
            rows.append(vals[:8])
    return np.asarray(rows, dtype=np.float64)


def rows_to_poses(rows: np.ndarray) -> np.ndarray:
    """(N, 8) TUM rows [stamp t q(xyzw)] -> (N, 4, 4) float64 poses."""
    n = len(rows)
    T = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    T[:, :3, 3] = rows[:, 1:4]
    x, y, z, w = (rows[:, 4 + i] for i in range(4))
    T[:, 0, 0] = 1 - 2 * (y * y + z * z)
    T[:, 0, 1] = 2 * (x * y - z * w)
    T[:, 0, 2] = 2 * (x * z + y * w)
    T[:, 1, 0] = 2 * (x * y + z * w)
    T[:, 1, 1] = 1 - 2 * (x * x + z * z)
    T[:, 1, 2] = 2 * (y * z - x * w)
    T[:, 2, 0] = 2 * (x * z - y * w)
    T[:, 2, 1] = 2 * (y * z + x * w)
    T[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return T


def write_trajectory(path, stamps: Sequence[float], poses, comment: str = "") -> None:
    """TUM-format trajectory; poses (N, 4, 4) world_T_cam."""
    t, q = se3.pose_to_tum(torch.as_tensor(np.asarray(poses), dtype=torch.float32))
    t, q = t.numpy(), q.numpy()
    lines = [f"# {comment}"] if comment else []
    for i, ts in enumerate(stamps):
        lines.append(f"{ts:.6f} " + " ".join(f"{x:.7f}" for x in t[i])
                     + " " + " ".join(f"{x:.7f}" for x in q[i]))
    Path(path).write_text("\n".join(lines) + "\n")
