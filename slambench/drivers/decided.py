"""One sequence after another on the host-decision path, where a frame
becomes a node only when the host accepts a registration.

The serial driver (``drivers/serial.py``) with two changes:

* node n is not frame n: a frame the program dropped leaves no node, so
  the judge's node-to-frame map comes from the graph's own timestamps
  (``GraphManager.timestamps``, each the stamp of the frame the node
  holds; a first node replaced by a later frame holds that frame's);
* a traced run profiles `trace_frames` frames from frame `trace_from` of
  the first sequence, inside the window, where the graph is near its full
  size and every frame runs an online optimize over it; their benchmark
  spans and counters are left out of the record, as the lockstep driver
  leaves out its traced segment's.

Everything else (set-up, chunks through ``SlamPipeline.run_arrays``, the
sequence's blocking optimize and protocol inside the window, the
extractor's device time after a traced window) is the serial driver's.
"""
from __future__ import annotations

from drivers import serial
from lib import judge, trace as tracing


class Driver(serial.Driver):
    def __init__(self, cell: dict, seed: int, rec, device: str = "cuda"):
        super().__init__(cell, seed, rec, device)
        self.trace_at = None  # the frame a traced run profiles from

    def counters(self) -> dict:
        out = super().counters()
        if self.pipe is not None:  # a program without them counts none
            mgr = self.pipe.manager
            out["online_optimizes"] = getattr(mgr, "online_optimizes", 0)
            out["online_lm_iterations"] = getattr(mgr, "online_lm_iterations", 0)
        return out

    def _snapshot(self, k: int, finished: bool) -> None:
        mgr = self.pipe.manager
        index = {float(t): i for i, t in enumerate(self.stamps)}
        frames = [index[float(t)] for t in mgr.timestamps]
        frame_of = self.frame_of(k)
        self.snapshots.append(judge.snapshot(
            mgr, self.fed, finished, self.rng, self.tr["judge_edges_per_sequence"],
            self.tr["judge_frames_per_sequence"], lambda n: frame_of(frames[n])))

    # -- the traced segment -------------------------------------------------
    def trace_segment(self):
        """Arm the traced segment: `trace_frames` frames from `trace_from`,
        profiled inside the window."""
        self.trace_at = self.tr["trace_from"]

    def advance(self) -> int:
        if self.trace_at is not None and self.pipe is not None and self.fed >= self.trace_at:
            self.trace_at = None
            return self._traced()
        return super().advance()

    def _traced(self) -> int:
        rec = self.rec
        spans = {k: len(v) for k, v in rec.spans.items()}
        self._retire()
        N = self.cfg["data"]["frames"]
        frames = []

        def run():
            while sum(frames) < self.tr["trace_frames"] and self.fed < N:
                frames.append(serial.Driver.advance(self))

        rec.profile = tracing.profile(run)
        self._mark()
        for k in list(rec.spans):
            del rec.spans[k][spans.get(k, 0):]
        return sum(frames)
