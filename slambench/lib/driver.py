"""What the traffic drivers share: the mix's sequences rendered in set-up,
the program's counters over the window, and the window's loop.

A driver (``slambench/drivers/<name>.py``, named by a mix's ``driver``
key) subclasses :class:`Driver` and gives ``setup``, ``advance`` (the next
piece of traffic: returns the frames it completed, and counts in
``self.ends`` each end of a sequence or round), ``counters`` (the program's
own counters now), ``trace_segment`` and ``close``.
"""
from __future__ import annotations

import time

import numpy as np

from . import render
from .env import log


class Driver:
    # ends a whole cycle of the mix's fixed worlds takes
    cycle = 1

    def __init__(self, cell: dict, seed: int, rec, device: str = "cuda"):
        self.cfg, self.tr = cell["config_data"], cell["traffic_data"]
        self.seed, self.rec, self.device = seed, rec, device
        self.params = dict(self.cfg["params"], **self.tr.get("param_overrides", {}))
        self.snapshots = []
        self.rng = np.random.default_rng([int(seed) % 2**64, 1])
        self.ends = 0
        self._base = {}

    # -- the inputs -----------------------------------------------------------
    def render(self, n: int) -> None:
        """The mix's n fixed worlds (``world_set``), in an order drawn from
        the seed and with depth noise from it, into host arrays rgbs (n, N,
        H, W, 3) u8 and depths (n, N, H, W) u16; their poses (n, N, 4, 4)."""
        cam = render.Camera(**self.cfg["camera"])
        N = self.cfg["data"]["frames"]
        rnd = self.cfg["render"]
        self.rgbs = np.empty((n, N, cam.height, cam.width, 3), np.uint8)
        self.depths = np.empty((n, N, cam.height, cam.width), np.uint16)
        order = render.run_order(self.seed, n)  # the k-th sequence runs world order[k]
        self.poses = np.stack([render.render_into(
            self.rgbs[k], self.depths[k], self.tr["world_set"], int(order[k]),
            render.noise_seed(self.seed, k), cam, rnd["deg_per_frame"],
            rnd["depth_noise_sigma"], self.device) for k in range(n)])
        self.stamps = np.arange(N) / float(self.cfg["data"]["fps"])
        log(f"rendered {n} x {N} frames")

    def frame_of(self, k: int):
        """frame_of(node) -> (rgb, depth) copies of sequence k's frame."""
        return lambda n: (self.rgbs[k, n].copy(), self.depths[k, n].copy())

    # -- the program's counters over the window ------------------------------
    def counters(self) -> dict:
        return {}

    def _mark(self) -> None:
        self._base = self.counters()

    def _retire(self) -> None:
        """Add what the counters moved since the mark to the record (before
        the program object that holds them goes)."""
        for k, v in self.counters().items():
            self.rec.counters[k] += v - self._base.get(k, 0)
        self._base = {}

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float, ends: int = None) -> None:
        """Run the traffic until `ends` ends have come, or else until the
        first end after `seconds` that closes a whole cycle of the mix's
        worlds, then synchronize: the window holds whole cycles, so where
        the time runs out does not change the work it measures."""
        self._mark()
        self._sync()
        t0 = time.perf_counter()
        frames = 0
        while True:
            before = self.ends
            frames += self.advance()
            if self.ends == before:
                continue
            if ends is not None:
                if self.ends >= ends:
                    break
            elif self.ends % self.cycle == 0 and time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        self.rec.window_s = time.perf_counter() - t0
        self.rec.frames = frames
