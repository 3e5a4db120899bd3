"""Absolute trajectory error (ATE) after Horn alignment.

Port of ``rgbdslam_v2_tpu/eval/ate.py::evaluate_ate`` (and its
``TrajectoryError`` statistics).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

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
