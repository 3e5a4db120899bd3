"""A suite of sequences in lockstep, as the slam-multi CLI sweeps one.

Traffic: `sequences` sequences of the configuration's length, the fixed
worlds of `world_set` (room and orbit) in an order drawn from the seed,
each with its own depth noise, advanced together by one
``MultiSequenceSlam``, closed loop, on the CLI's schedule
(``rgbdslam_v2_tpu_torch/apps/cli.py``, ``cmd_slam_multi``, copied here):
each lockstep frame's frames are encoded in the loop with
``MultiSequenceSlam.compact`` and fed through ``add_frames``; every
``optimizer_skip_step`` lockstep frames ``optimize(online iterations,
blocking=False)``; at a round's end the 5-level ``evaluation_protocol``
(its level 1 is the final optimize), and a new round starts from the first
frame on a fresh ``MultiSequenceSlam``.

Set-up renders the suite and runs the round's first `warmup_frames`
lockstep frames (its first step eager, its second captured), as
``bench.py`` warms up. The window holds the rest of the round and its end,
and closes at the first round end after `--seconds`: it always holds whole
rounds, so where the time runs out does not change what it measures.
A traced run profiles `trace_frames` lockstep frames from `trace_from`
inside the window, where the graphs are near their full size and one
online optimize falls; their spans and counters are left out of the
record.
"""
from __future__ import annotations

import gc

import numpy as np

from lib import driver, judge, trace as tracing
from lib.env import log
from lib.roofline import detect_bound_s


class Driver(driver.Driver):
    def __init__(self, cell: dict, seed: int, rec, device: str = "cuda"):
        super().__init__(cell, seed, rec, device)
        self.ms = None
        self.k = 0  # the next lockstep frame of the round
        self.trace_at = None  # the lockstep frame a traced run profiles from

    def _new_suite(self):
        from rgbdslam_v2_tpu_torch.config import ParameterServer
        from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
        from rgbdslam_v2_tpu_torch.parallel.slam_multi import MultiSequenceSlam

        self.p = ParameterServer(dict(self.params))
        return MultiSequenceSlam(Intrinsics(**self.cfg["camera"]), self.tr["sequences"],
                                 params=self.p, device=self.device)

    def counters(self) -> dict:
        steps = [sh.steps for sh in self.ms.shards if sh.steps is not None] if self.ms else []
        return {"replay_s": sum(s.replay_s for s in steps),
                "replays": sum(s.replays for s in steps)}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        self.render(self.tr["sequences"])
        self.ms = self._new_suite()
        log("suite built")
        for _ in range(self.tr["warmup_frames"]):
            self.advance()
        log(f"warmed up on {self.tr['warmup_frames']} lockstep frames")
        self._sync()

    # -- the traffic: the slam-multi CLI's loop -----------------------------
    def advance(self) -> int:
        """One lockstep frame (or, past the round's last, the round's end);
        returns the sequence-frames completed."""
        if self.k == self.trace_at:
            self.trace_at = None
            return self._traced()
        S, N = self.tr["sequences"], self.cfg["data"]["frames"]
        k = self.k
        if k >= N:
            self._end_round()
            return 0
        if self.ms is None:  # the next round's suite, built as its first frame comes
            self.ms = self._new_suite()
            self._mark()
        rec, ms = self.rec, self.ms
        with rec.span("encode"):
            cpts = [ms.compact(self.rgbs[s, k], self.depths[s, k]) for s in range(S)]
        with rec.span("add_frames"):
            ms.add_frames(np.stack(cpts), np.full(S, self.stamps[k]),
                          gt_poses=self.poses[:, 0] if k == 0 else None)
        if (k + 1) % self.p["optimizer_skip_step"] == 0:
            with rec.span("online_opt"):
                ms.optimize(iterations=self.p["online_optimizer_iterations"], blocking=False)
        self.k = k + 1
        return S

    def _end_round(self) -> None:
        ms = self.ms
        with self.rec.span("round_end"):
            _, ate = ms.evaluation_protocol(
                gt_stamps=[list(self.stamps)] * ms.S,
                gt_xyz=[self.poses[s, :, :3, 3] for s in range(ms.S)])
        self.rec.values.setdefault("ate_l4_m", []).extend(np.asarray(ate.get(4, [])).tolist())
        self._snapshots(self.cfg["data"]["frames"], True)
        self._retire()
        self.ms = None
        del ms
        gc.collect()
        self.ends += 1
        self.k = 0

    def _snapshots(self, fed: int, finished: bool) -> None:
        for s, sq in enumerate(self.ms.seq):
            self.snapshots.append(judge.snapshot(
                sq, fed, finished, self.rng, self.tr["judge_edges_per_sequence"],
                self.tr["judge_frames_per_sequence"], self.frame_of(s)))

    def trace_segment(self):
        """Arm the traced segment: `trace_frames` lockstep frames from
        `trace_from`, profiled inside the window."""
        self.trace_at = self.tr["trace_from"]
        cam = self.cfg["camera"]
        self.rec.values["detect_bound_s"] = detect_bound_s(cam["height"], cam["width"])

    def _traced(self) -> int:
        rec = self.rec
        spans = {k: len(v) for k, v in rec.spans.items()}
        self._retire()
        frames = []

        def run():
            for _ in range(self.tr["trace_frames"]):
                frames.append(self.advance())

        rec.profile = tracing.profile(run)
        self._mark()
        for k in list(rec.spans):
            del rec.spans[k][spans.get(k, 0):]
        return sum(frames)

    def close(self) -> list:
        if self.ms is not None:
            if self.k:
                self.ms.statistics()  # drain every sequence
                self._snapshots(self.k, False)
            self._retire()
        self.ms = None
        gc.collect()
        return self.snapshots
