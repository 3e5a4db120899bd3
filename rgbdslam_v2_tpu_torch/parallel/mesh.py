"""The device mesh that sequences, candidates and pose-graph edges shard
over.

Port of ``rgbdslam_v2_tpu/parallel/mesh.py::candidate_mesh``. The
reference's concurrency (QtConcurrent thread pools over edge candidates,
background optimization; src/graph_manager.cpp:531-583, :900-909) maps to
data parallelism over a 1-D mesh, axis "c": loop-closure candidates,
graph edges, or whole sequences, one contiguous shard a device.

A mesh here is an ordered tuple of torch devices. CPU shards (the same
CPU device n times) stand in for the JAX tests' virtual host devices, so
the multi-shard code runs without cards. Unlike the JAX function, a
request for cards never falls back to CPU devices: it raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices of a 1-D mesh, in shard order; a device may repeat (CPU
    shards, or two shards on one card)."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "c"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    def blocks(self, n: int):
        """The contiguous block of range(n) each shard holds, as
        (device, start, stop); n must divide by the mesh size."""
        if n % self.size:
            raise ValueError(f"{n} items not divisible by {self.size} devices")
        m = n // self.size
        return [(d, k * m, (k + 1) * m) for k, d in enumerate(self.devices)]


def on_device(device: torch.device):
    """A context that makes `device` the current CUDA device (a no-op for
    the CPU): a hand-written kernel launches on the current device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def candidate_mesh(n_devices: Optional[int] = None, platform: Optional[str] = None) -> DeviceMesh:
    """A 1-D mesh of n devices: with platform "cpu", n CPU shards (1 when
    n is None); otherwise the first n CUDA devices (every one when n is
    None). ValueError where there are fewer than n (or none)."""
    if platform == "cpu":
        return DeviceMesh((torch.device("cpu"),) * (n_devices or 1))
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or have
    if n < 1 or n > have:
        raise ValueError(f"requested {n_devices or 'all'} CUDA devices, have {have}"
                         if n < 1 else f"requested {n} devices, have {have}")
    return DeviceMesh(tuple(torch.device("cuda", k) for k in range(n)))
