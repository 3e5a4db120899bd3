"""Kinect-style depth noise model.

Port of ``rgbdslam_v2_tpu/core/noise.py`` (depth_covariance,
lateral_covariance, point_covariance_diag).
"""
from __future__ import annotations

import torch

DEFAULT_SIGMA_DEPTH = 0.01
DEPTH_COV_SCALE = 1.0


def depth_std_dev(z: torch.Tensor, sigma_depth: float = DEFAULT_SIGMA_DEPTH):
    return sigma_depth * z * z


def depth_covariance(z: torch.Tensor, sigma_depth: float = DEFAULT_SIGMA_DEPTH):
    sd = depth_std_dev(z, sigma_depth) * DEPTH_COV_SCALE
    return sd * sd + 1e-9


def lateral_covariance(z: torch.Tensor, focal: float):
    raster_stddev = z / focal
    return (raster_stddev * raster_stddev) / 9.0 + 1e-12


def point_covariance_diag(z: torch.Tensor, fx: float, fy: float,
                          sigma_depth: float = DEFAULT_SIGMA_DEPTH) -> torch.Tensor:
    """Diagonal (..., 3) of a backprojected point's covariance."""
    return torch.stack(
        [lateral_covariance(z, fx), lateral_covariance(z, fy),
         depth_covariance(z, sigma_depth)],
        dim=-1,
    )
