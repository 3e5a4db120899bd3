"""Visual odometry over many sequences at once, sharded over a mesh.

Port of ``rgbdslam_v2_tpu/parallel/multi_eval.py`` (``VoResult``,
``vo_trajectories_sharded``): the evaluation axis SURVEY.md section 2.3
adds to the reference, which runs its benchmark sequences one after
another (test/run_tests.sh). Each sequence runs the frontend's hot path
frame by frame: extract, match to the predecessor
(ops/matching.match_descriptors), RANSAC (ops/registration.ransac_register),
chain the motion. The JAX ``lax.scan`` over frames is a loop here; the
sequences split into contiguous blocks over the mesh devices, and every
frame queues each sequence's work on its device in turn, so the devices
run side by side. Each frame of each sequence launches the detect kernel
once and, after the first, the refine kernel once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import backend
from ..core.camera import Intrinsics
from ..models.orb import feature_depth_map
from ..ops.matching import match_descriptors
from ..ops.registration import ransac_register
from .mesh import DeviceMesh, on_device


class VoResult(NamedTuple):
    poses: torch.Tensor  # (S, T, 4, 4) world_T_cam per frame, the first at identity
    n_inliers: torch.Tensor  # (S, T) int32 per-frame inlier counts
    ok: torch.Tensor  # (S, T) bool RANSAC success (frame 0 True)


def sequence_generator(seed: int, s: int, device) -> torch.Generator:
    """Sequence s's RANSAC generator: seeded with the first 64-bit word
    of numpy's SeedSequence([seed, s]) (the counterpart of the JAX
    package's jax.random.split(key, S)[s])."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, s]).generate_state(1, np.uint64)[0]))
    return g


class _Chain:
    """One sequence's VO state on its device."""

    def __init__(self, grays, depths, gen, extractor, cam, kw):
        self.grays, self.depths, self.gen = grays, depths, gen
        self.extractor, self.cam, self.kw = extractor, cam, kw
        dev = grays.device
        self.pose = torch.eye(4, device=dev)
        self.poses = [self.pose]
        self.n_inl = [torch.zeros((), dtype=torch.int32, device=dev)]
        self.ok = [torch.ones((), dtype=torch.bool, device=dev)]
        self.prev = self.extract(0)

    def extract(self, t: int):
        depth = self.depths[t]
        return self.extractor(self.grays[t], feature_depth_map(depth, depth > 0, False), self.cam)

    def step(self, t: int) -> None:
        kp, prev, kw = self.extract(t), self.prev, self.kw
        m = match_descriptors(kp.desc, kp.valid, prev.desc[None], prev.valid[None],
                              kw["max_matches"], kw["ratio"])
        dst = prev.xyz[m.dst_idx[0]][None]
        reg = ransac_register(self.gen, kp.xyz[m.src_idx], dst, m.dist, m.valid,
                              cam_fx=self.cam.fx, cam_fy=self.cam.fy,
                              n_hypotheses=kw["n_hypotheses"], min_inliers=kw["min_inliers"],
                              sigma_depth=kw["sigma_depth"])
        # prev_T_new on success; identity (constant position) otherwise
        T = torch.where(reg.success[0], reg.transform[0], torch.eye(4, device=dst.device))
        self.pose = self.pose @ T
        self.poses.append(self.pose)
        self.n_inl.append(reg.n_inliers[0])
        self.ok.append(reg.success[0])
        self.prev = kp


@torch.inference_mode()
def vo_trajectories_sharded(
    mesh: Optional[DeviceMesh],
    grays,  # (S, T, H, W) float32 in [0, 1]; S divisible by the mesh size
    depths,  # (S, T, H, W) float32 metres, 0 where invalid
    seed: int,
    extractor,
    cam: Intrinsics,
    max_matches: int = 128,
    ratio: float = 0.9,
    n_hypotheses: int = 128,
    min_inliers: int = 10,
    sigma_depth: float = 0.01,
    device=None,
) -> VoResult:
    """Sequential VO on S sequences, sequence s drawing from
    sequence_generator(seed, s). With a mesh the sequences split into
    contiguous blocks over its devices; without one all run on `device`
    (the CUDA card unless the CPU is asked for). Returns the results on
    the first device."""
    S, T = len(grays), len(grays[0])
    if mesh is None:
        mesh = DeviceMesh((backend.resolve_device(device),))
    kw = dict(max_matches=max_matches, ratio=ratio, n_hypotheses=n_hypotheses,
              min_inliers=min_inliers, sigma_depth=sigma_depth)
    chains = []
    for dev, lo, hi in mesh.blocks(S):
        for s in range(lo, hi):
            g = torch.as_tensor(np.asarray(grays[s], np.float32)).to(dev)
            d = torch.as_tensor(np.asarray(depths[s], np.float32)).to(dev)
            with on_device(dev):
                chains.append(_Chain(g, d, sequence_generator(seed, s, dev), extractor, cam, kw))
    for t in range(1, T):
        for c in chains:
            with on_device(c.grays.device):
                c.step(t)
    first = mesh.devices[0]
    return VoResult(
        poses=torch.stack([torch.stack(c.poses).to(first) for c in chains]),
        n_inliers=torch.stack([torch.stack(c.n_inl).to(first) for c in chains]),
        ok=torch.stack([torch.stack(c.ok).to(first) for c in chains]))
