"""One sequence after another, as an evaluator runs a published sequence.

Traffic: the `sequences` fixed worlds of `world_set`, each of the
configuration's length, in an order drawn from the seed (the first again
after the last), closed loop. Each runs in a fresh ``SlamPipeline`` and is
fed through ``SlamPipeline.run_arrays`` in chunks of `chunk_groups` whole
groups; it ends with a blocking optimize and the 5-level
``evaluation_protocol`` (trajectory files under TMPDIR), inside the window,
as ``bench.py`` and ``chip_smoke.bench_config_run`` end theirs.

Set-up, as ``bench.py`` warms up: the first sequence's first
`warmup_frames` frames one at a time through ``process_frame``, then a
blocking optimize. The window continues that sequence and closes at the
first end of a whole cycle of the worlds after `--seconds`: every run
measures every world, whole.
"""
from __future__ import annotations

import gc
import tempfile
from pathlib import Path

import numpy as np

from lib import driver, judge, trace as tracing
from lib.env import log
from lib.roofline import refine_bound_s


class Driver(driver.Driver):
    def __init__(self, cell: dict, seed: int, rec, device: str = "cuda"):
        super().__init__(cell, seed, rec, device)
        self.cycle = self.tr["sequences"]
        self.tmp = tempfile.TemporaryDirectory(prefix="slambench-")
        self.fed = 0  # frames handed to the current pipeline
        self.pipe = None

    # -- the program ------------------------------------------------------
    def _new_pipe(self):
        from rgbdslam_v2_tpu_torch.config import ParameterServer
        from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
        from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

        pipe = SlamPipeline(Intrinsics(**self.cfg["camera"]), ParameterServer(dict(self.params)),
                            device=self.device)
        if self.rec.trace:
            self.rec.wrap(pipe.manager, "encode", "encode")
        return pipe

    def counters(self) -> dict:
        if self.pipe is None:
            return {}
        sg = self.pipe.manager.step_graph
        return {"manager_wall_s": self.pipe.wall_time, "manager_frames": self.pipe.n_processed,
                "replay_s": sg.replay_s if sg else 0.0, "replays": sg.replays if sg else 0}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        self.render(self.tr["sequences"])
        self.pipe = self._new_pipe()
        log("pipeline built")
        for i in range(self.tr["warmup_frames"]):
            self.pipe.process_frame(self.rgbs[0, i], self.depths[0, i], float(self.stamps[i]),
                                    gt_pose=self.poses[0, 0] if i == 0 else None)
        self.pipe.manager.optimize(blocking=True)
        self.fed = self.tr["warmup_frames"]
        log(f"warmed up on {self.fed} frames")
        self._sync()

    # -- the traffic ------------------------------------------------------
    def advance(self) -> int:
        """The next chunk of the current sequence; at its end the
        sequence's final optimize and protocol. Returns the frames
        completed."""
        k = self.ends % self.tr["sequences"]
        N = self.cfg["data"]["frames"]
        if self.fed >= N:
            self._end_sequence(k)
            return 0
        if self.pipe is None:  # the next sequence's pipeline, built as its first chunk comes
            self.pipe = self._new_pipe()
            self._mark()
        n = self.tr["chunk_groups"] * self.params["tpu_frames_per_step"] + (self.fed == 0)
        a, b = self.fed, min(self.fed + n, N)
        self.pipe.run_arrays(self.rgbs[k, a:b], self.depths[k, a:b], self.stamps[a:b],
                             gt_poses=self.poses[k, a:b] if a == 0 else None)
        self.fed = b
        return b - a

    def _end_sequence(self, k: int) -> None:
        pipe = self.pipe
        with self.rec.span("final_opt"):
            pipe.manager.optimize(blocking=True)
            rep = pipe.evaluation_protocol(Path(self.tmp.name) / f"seq{self.ends}",
                                           gt_stamps=list(self.stamps),
                                           gt_xyz=self.poses[k, :, :3, 3])
        self.rec.values.setdefault("ate_l4_m", []).append(rep.ate_rmse.get(4))
        self._snapshot(k, True)
        self._retire()
        self.pipe = None
        del pipe
        gc.collect()
        self.ends += 1
        self.fed = 0

    def _snapshot(self, k: int, finished: bool) -> None:
        self.snapshots.append(judge.snapshot(
            self.pipe.manager, self.fed, finished, self.rng, self.tr["judge_edges_per_sequence"],
            self.tr["judge_frames_per_sequence"], self.frame_of(k)))

    def trace_segment(self):
        """One chunk under the profiler, before the window, with the
        refine kernel's inlier counts recorded from the drained summaries;
        one chunk before it runs the first group's eager step and capture."""
        self.advance()
        host = self.pipe.manager.host
        inliers = []
        apply = host.apply_summary

        def recording(new_id, padded, edge_start, s):
            inliers.append(np.asarray(s.n_inliers, np.float64))
            return apply(new_id, padded, edge_start, s)

        host.apply_summary = recording
        self.rec.profile = tracing.profile(self.advance)
        self.pipe.manager.statistics()  # drain, so the segment's summaries are read
        del host.apply_summary
        p = self.params
        mean_inl = np.mean(inliers, axis=0) if inliers else np.zeros(p["tpu_candidate_batch"])
        self.rec.values["refine_bound_s"] = refine_bound_s(
            p["tpu_candidate_batch"], p["max_matches"], p["refine_iterations"], mean_inl)

    def close(self) -> list:
        """After the window: the unfinished sequence's answers, then the
        extractor's device time (traced runs); frees the program's state."""
        if self.pipe is not None:
            if self.fed:
                self.pipe.manager.statistics()  # drain
                self._snapshot(self.ends % self.tr["sequences"], False)
            self._retire()
        if self.rec.trace and self.device != "cpu":
            self._extract_time(self.pipe or self._new_pipe())
        self.pipe = None
        gc.collect()
        self.tmp.cleanup()
        return self.snapshots

    def _extract_time(self, pipe) -> None:
        mgr = pipe.manager
        k = self.ends % self.tr["sequences"]
        n = self.tr["extract_calls"]
        packed = [mgr._to_device(mgr.encode(self.rgbs[k, i], self.depths[k, i]))
                  for i in range(n)]
        it = iter(range(10**9))
        self.rec.values["extract_device_ms"] = tracing.device_ms_per_call(
            lambda: mgr._extract(packed[next(it) % n]), n)
