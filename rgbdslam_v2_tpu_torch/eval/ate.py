"""Trajectory errors: ATE after Horn alignment, and RPE over a frame delta.

Port of ``rgbdslam_v2_tpu/eval/ate.py`` (``evaluate_ate``, ``evaluate_rpe``
and their ``TrajectoryError`` statistics), float32 on the CPU like the JAX
version.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import alignment, se3
from ..io.tum import associate


@dataclasses.dataclass
class TrajectoryError:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    n_pairs: int

    def as_dict(self):
        return dataclasses.asdict(self)


def _stats(err: np.ndarray) -> TrajectoryError:
    return TrajectoryError(
        rmse=float(np.sqrt(np.mean(err**2))), mean=float(np.mean(err)),
        median=float(np.median(err)), std=float(np.std(err)),
        min=float(np.min(err)), max=float(np.max(err)), n_pairs=int(err.shape[0]),
    )


def evaluate_ate(est_stamps: Sequence[float], est_xyz, gt_stamps: Sequence[float],
                 gt_xyz, max_difference: float = 0.02) -> TrajectoryError:
    """Translational ATE after timestamp association and Horn alignment
    (float32 on the CPU, like the JAX version)."""
    pairs = associate(list(est_stamps), list(gt_stamps), max_difference)
    if len(pairs) < 2:
        raise ValueError(f"only {len(pairs)} associated pose pairs")
    ei = np.asarray([p[0] for p in pairs])
    gi = np.asarray([p[1] for p in pairs])
    est = torch.as_tensor(np.asarray(est_xyz)[ei], dtype=torch.float32)
    gt = torch.as_tensor(np.asarray(gt_xyz)[gi], dtype=torch.float32)
    T, _ = alignment.horn_align_trajectories(est, gt)
    aligned = se3.apply(T, est).numpy()
    return _stats(np.linalg.norm(aligned - gt.numpy(), axis=-1))


def evaluate_rpe(est_poses, gt_poses, delta: int = 1) -> Tuple[TrajectoryError, TrajectoryError]:
    """Relative pose error over a frame delta on index-aligned (N, 4, 4)
    pose arrays: (translational [m], rotational [rad]) statistics."""
    est = torch.as_tensor(np.asarray(est_poses), dtype=torch.float32)
    gt = torch.as_tensor(np.asarray(gt_poses), dtype=torch.float32)
    rel_est = se3.inv(est[:-delta]) @ est[delta:]
    rel_gt = se3.inv(gt[:-delta]) @ gt[delta:]
    err = se3.inv(rel_gt) @ rel_est
    terr = torch.linalg.norm(err[:, :3, 3], dim=-1)
    tr = err[:, 0, 0] + err[:, 1, 1] + err[:, 2, 2]
    rerr = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    return _stats(terr.numpy()), _stats(rerr.numpy())
