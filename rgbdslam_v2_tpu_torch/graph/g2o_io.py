"""g2o text-format graph export and import (VERTEX_SE3:QUAT, EDGE_SE3:QUAT).

Port of ``rgbdslam_v2_tpu/graph/g2o_io.py`` (``write_g2o``, ``read_g2o``;
reference graph_mgr_io.cpp:933 saveG2OGraph): numpy in and out, the
quaternion conversions on CPU tensors through the port's ``core/se3``, so
the text is the JAX writer's for the same poses.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core import se3


def _tum_rows(T) -> np.ndarray:
    """(N, 4, 4) poses -> (N, 7) float32 rows [t, q xyzw], converted in one
    batch (one conversion a pose cost ~1 ms each in torch's op overhead)."""
    T = np.array(T, np.float32).reshape(-1, 4, 4)
    t, q = se3.pose_to_tum(torch.from_numpy(T))
    return np.concatenate([t.numpy(), q.numpy()], axis=1)


def _text(row) -> str:
    return " ".join(f"{x:.9g}" for x in row)


def _line_to_pose(vals) -> np.ndarray:
    v = torch.as_tensor(np.asarray(vals, np.float32))
    return se3.tum_to_pose(v[:3], v[3:7]).numpy()


def write_g2o(path, poses, fixed_ids, edges) -> None:
    """poses (N, 4, 4); fixed_ids: ints; edges: (i, j, meas (4, 4), info (6, 6))."""
    edges = list(edges)
    lines = [f"VERTEX_SE3:QUAT {i} {_text(r)}" for i, r in enumerate(_tum_rows(poses))]
    lines += [f"FIX {i}" for i in fixed_ids]
    if edges:
        meas = _tum_rows(np.stack([np.asarray(e[2], np.float32) for e in edges]))
        iu = np.triu_indices(6)
        for (i, j, _, info), m in zip(edges, meas):
            lines.append(f"EDGE_SE3:QUAT {i} {j} {_text(m)} {_text(np.asarray(info)[iu])}")
    Path(path).write_text("\n".join(lines) + "\n")


def read_g2o(path):
    """(poses {id: (4, 4)}, fixed ids (set), edges [(i, j, meas, info)])."""
    poses, fixed, edges = {}, set(), []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "VERTEX_SE3:QUAT":
            poses[int(parts[1])] = _line_to_pose([float(x) for x in parts[2:9]])
        elif parts[0] == "FIX":
            fixed.add(int(parts[1]))
        elif parts[0] == "EDGE_SE3:QUAT":
            meas = _line_to_pose([float(x) for x in parts[3:10]])
            info = np.zeros((6, 6))
            info[np.triu_indices(6)] = [float(x) for x in parts[10:31]]
            edges.append((int(parts[1]), int(parts[2]), meas, info + np.triu(info, 1).T))
    return poses, fixed, edges
