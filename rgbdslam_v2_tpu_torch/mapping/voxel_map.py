"""Color occupancy voxel map (the reference's ColorOctomapServer).

Port of ``rgbdslam_v2_tpu/mapping/voxel_map.py``: ``VoxelMapConfig``,
``VoxelMap`` (``insert_cloud``, ``occupancy_filter``, ``occupied_voxels``,
``save``, ``reset``). A dense log-odds grid on the map's device, flat
``(nx*ny*nz,)`` tensors: logodds and hits float32, rgb_sum (n, 3) float32;
at 256x256x128 voxels 8.4 M voxels, 168 MB.

``insert_cloud`` is the JAX package's fixed-step ray walk (reference
ColorOctomapServer.cpp:61-129): ``max_ray_steps`` samples a point at
(k + 0.5) x resolution along its ray, a miss update in every in-bounds
voxel a sample before the endpoint reaches, then a hit update at each
endpoint, then the clip to the clamping bounds; colours and hit counts
summed at the endpoints. The updates are ``index_add_`` of the in-bounds
samples (atomic adds on the card). Every miss adds the same constant and
every hit the same constant, colours and counts are integers below 2^24, so
the order in which the adds land cannot change a sum, and a ray's length
is summed in one fixed order and rounded correctly on every device
(``ray_length``): the card's map equals the CPU's. The voxel of a sample is ``floor((p - origin) * (1/resolution))``
with the float32 reciprocal, as XLA compiles the JAX division by a constant.
``occupied_voxels`` and ``save`` run on the host in numpy, as in the JAX
package, so the ``.ot`` bytes are the JAX writer's for the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend


@dataclasses.dataclass(frozen=True)
class VoxelMapConfig:
    resolution: float = 0.05
    # grid dimensions (voxels); world volume = dims * resolution from origin
    nx: int = 256
    ny: int = 256
    nz: int = 128
    origin: tuple = (0.0, 0.0, 0.0)  # world position of voxel (0, 0, 0)'s corner
    prob_hit: float = 0.7
    prob_miss: float = 0.4
    clamp_min: float = 0.12
    clamp_max: float = 0.97
    occupancy_threshold: float = 0.5
    max_ray_steps: int = 160  # rays longer than steps * resolution are truncated

    @property
    def logodds_hit(self):
        return float(np.log(self.prob_hit / (1 - self.prob_hit)))

    @property
    def logodds_miss(self):
        return float(np.log(self.prob_miss / (1 - self.prob_miss)))

    @property
    def logodds_min(self):
        return float(np.log(self.clamp_min / (1 - self.clamp_min)))

    @property
    def logodds_max(self):
        return float(np.log(self.clamp_max / (1 - self.clamp_max)))

    @property
    def n_voxels(self) -> int:
        return self.nx * self.ny * self.nz


def ray_length(d: torch.Tensor) -> torch.Tensor:
    """|d| of (N, 3) float32 vectors, the same bits on every device: the
    squares summed in one fixed order, elementwise (a reduction kernel's
    order differs between the card and the CPU), and the square root taken
    in float64 and rounded to float32, which is the correctly rounded
    float32 root. torch's float32 sqrt on the CPU is not: it differs from
    the card's (and the float64 root's) in the last bit on some rays, and
    a last-bit change of a ray's length moves samples across voxel faces.
    XLA on the CPU contracts the sum to fma(z, z, fma(y, y, x * x)), so
    the JAX package's lengths can differ from these in the last bit; the
    tests find no voxel where that matters on their clouds."""
    s = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    return torch.sqrt(s.double()).float()


def _recip32(v: float) -> float:
    """1/v rounded to float32 (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(v))


class VoxelMap:
    def __init__(self, config: VoxelMapConfig = VoxelMapConfig(), device=None):
        """The map's state lives on `device`: the CUDA card unless the
        caller names the CPU."""
        self.cfg = config
        self.device = backend.resolve_device(device)
        n = config.n_voxels
        self.logodds = torch.zeros(n, dtype=torch.float32, device=self.device)
        self.rgb_sum = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        self.hits = torch.zeros(n, dtype=torch.float32, device=self.device)

    def _tensor(self, x, dtype) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        return t.to(self.device, dtype)

    def _ijk(self, p: torch.Tensor) -> torch.Tensor:
        origin = torch.tensor(self.cfg.origin, dtype=torch.float32, device=self.device)
        return torch.floor((p - origin) * _recip32(self.cfg.resolution)).to(torch.int32)

    def _in_bounds(self, ijk: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        hi = torch.tensor([c.nx, c.ny, c.nz], dtype=torch.int32, device=self.device)
        return ((ijk >= 0) & (ijk < hi)).all(-1)

    def _flat(self, ijk: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        i = ijk[..., 0].clamp(0, c.nx - 1).long()
        j = ijk[..., 1].clamp(0, c.ny - 1).long()
        k = ijk[..., 2].clamp(0, c.nz - 1).long()
        return (i * c.ny + j) * c.nz + k

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def insert_cloud(self, points_world, colors, valid, sensor_origin) -> None:
        """Ray-cast one cloud into the map: points_world (N, 3) float32,
        colors (N, 3) uint8 or float, valid (N,) bool, sensor_origin (3,)
        the camera's world position (tensors or arrays)."""
        c = self.cfg
        pts = self._tensor(points_world, torch.float32).reshape(-1, 3)
        cols = self._tensor(colors, torch.float32).reshape(-1, 3)
        valid = self._tensor(valid, torch.bool).reshape(-1)
        origin = self._tensor(sensor_origin, torch.float32).reshape(3)
        d = pts - origin
        dist = ray_length(d)
        dirn = d / torch.clamp(dist, min=1e-6)[:, None]

        # misses: the fixed-step samples strictly before the endpoint
        steps = (torch.arange(c.max_ray_steps, dtype=torch.float32, device=self.device)
                 + 0.5) * c.resolution
        sample = origin + dirn[:, None, :] * steps[None, :, None]  # (N, S, 3)
        on_ray = (steps[None, :] < (dist[:, None] - 0.5 * c.resolution)) & valid[:, None]
        ijk = self._ijk(sample)
        ok = on_ray & self._in_bounds(ijk)
        flat = self._flat(ijk[ok])
        self.logodds.index_add_(0, flat, torch.full(flat.shape, c.logodds_miss,
                                                    dtype=torch.float32, device=self.device))

        # hits at the endpoints, after the misses so that endpoints gain
        e_ijk = self._ijk(pts)
        e_ok = valid & self._in_bounds(e_ijk) & (dist > 0.05)
        e_flat = self._flat(e_ijk[e_ok])
        self.logodds.index_add_(0, e_flat, torch.full(e_flat.shape, c.logodds_hit,
                                                      dtype=torch.float32, device=self.device))
        self.logodds.clamp_(c.logodds_min, c.logodds_max)
        self.rgb_sum.index_add_(0, e_flat, cols[e_ok])
        self.hits.index_add_(0, e_flat, torch.ones(e_flat.shape, dtype=torch.float32,
                                                   device=self.device))

    @torch.inference_mode()
    def occupancy_filter(self, points_world, valid, threshold=None) -> torch.Tensor:
        """Keep the points whose voxel's occupancy is above threshold: the
        valid mask with the others cleared."""
        thr = self.cfg.occupancy_threshold if threshold is None else threshold
        pts = self._tensor(points_world, torch.float32).reshape(-1, 3)
        valid = self._tensor(valid, torch.bool).reshape(-1)
        ijk = self._ijk(pts)
        lo = self.logodds[self._flat(ijk)]
        prob = 1.0 / (1.0 + torch.exp(-lo))
        return valid & self._in_bounds(ijk) & (prob > thr)

    # ------------------------------------------------------------------
    def occupied_voxels(self):
        """Host export: (centers (M, 3) float64, probs (M,), colors (M, 3) u8)."""
        cfg = self.cfg
        lo = self.logodds.cpu().numpy()
        probs = 1.0 / (1.0 + np.exp(-lo))
        idx = np.nonzero(probs > cfg.occupancy_threshold)[0]
        iz = idx % cfg.nz
        iy = (idx // cfg.nz) % cfg.ny
        ix = idx // (cfg.nz * cfg.ny)
        centers = (np.stack([ix, iy, iz], -1).astype(np.float64) + 0.5) * cfg.resolution \
            + np.asarray(cfg.origin)
        sel = torch.from_numpy(idx).to(self.device)
        hits = np.maximum(self.hits[sel].cpu().numpy(), 1.0)[:, None]
        colors = (self.rgb_sum[sel].cpu().numpy() / hits).clip(0, 255).astype(np.uint8)
        return centers, probs[idx], colors

    def save(self, path) -> int:
        """Write an OctoMap .ot (ColorOcTree) through the host octree writer;
        returns its node count."""
        from .octree_io import write_color_octree

        centers, probs, colors = self.occupied_voxels()
        return write_color_octree(path, centers, probs, colors, self.cfg.resolution)

    def reset(self) -> None:
        self.__init__(self.cfg, self.device)
