"""Robot odometry: odometry edges between consecutive nodes.

Port of ``rgbdslam_v2_tpu/graph/odometry.py`` (``OdometryProvider``,
``odometry_information``; the reference's graph_mgr_odom.cpp:11-181,
parameters use_robot_odom{,_only} and odometry_information_factor).
Odometry arrives as per-frame world_T_base poses from any source (a wheel
odometry file, another tracker); the motion between two node stamps becomes
an edge measurement. Host code: the twist-space interpolation runs on CPU
float32 tensors, as the JAX version runs it on float32 arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import se3


class OdometryProvider:
    """Interpolating odometry lookup: timestamp -> world_T_base (4, 4).

    Mirrors the tf lookup at node stamps (graph_mgr_odom.cpp:76-101), with
    linear interpolation on SE(3) (a twist-space blend between the two
    bracketing poses); a stamp outside the poses' span by less than 0.5 s
    takes the nearest pose, one further out has none.
    """

    def __init__(self, stamps, poses):
        order = np.argsort(stamps)
        self.stamps = np.asarray(stamps, np.float64)[order]
        self.poses = np.asarray(poses, np.float32)[order]

    def lookup(self, t: float) -> Optional[np.ndarray]:
        if len(self.stamps) == 0:
            return None
        i = int(np.searchsorted(self.stamps, t))
        if i == 0:
            return self.poses[0] if abs(self.stamps[0] - t) < 0.5 else None
        if i >= len(self.stamps):
            return self.poses[-1] if abs(self.stamps[-1] - t) < 0.5 else None
        t0, t1 = self.stamps[i - 1], self.stamps[i]
        a = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        A = torch.from_numpy(self.poses[i - 1])
        B = torch.from_numpy(self.poses[i])
        delta = se3.log_se3(se3.relative(A, B))
        return (A @ se3.exp_se3(delta * float(a))).numpy()

    def delta(self, t0: float, t1: float) -> Optional[np.ndarray]:
        """The odometry frame's motion between two stamps: base0_T_base1."""
        A = self.lookup(t0)
        B = self.lookup(t1)
        if A is None or B is None:
            return None
        return se3.relative(torch.from_numpy(np.asarray(A)),
                            torch.from_numpy(np.asarray(B))).numpy()


def odometry_information(dt: float, odometry_information_factor: float) -> np.ndarray:
    """The reference's Ones * 0.001 * factor (graph_mgr_odom.cpp:41-54) as a
    diagonal information matrix (the reference's off-diagonal ones are an
    acknowledged quirk; the diagonal is the sound equivalent)."""
    return np.eye(6, dtype=np.float32) * (0.001 * odometry_information_factor)
