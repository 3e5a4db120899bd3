"""What one run records: the window, benchmark spans, program counters,
and (with --trace 1) the profiler's reduction. The per-layer metric
readers in ``slambench/metrics/`` read it and nothing else."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Record:
    def __init__(self, trace: bool):
        self.trace = trace
        self.setup_s = None  # seconds from the start of the process to the window
        self.window_s = None  # the measured window, host clock
        self.frames = 0  # frames (sequence-frames) completed in the window
        self.spans = defaultdict(list)  # name -> [seconds]
        self.counters = defaultdict(float)  # name -> value summed over the window
        self.values = {}  # name -> one reading (device times, shapes)
        self.profile = None  # lib.trace.Profile of the traced segment

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock span; with --trace 1 also a profiler annotation, so the
        idle gaps of the trace can be named by what the host was doing."""
        ann = None
        if self.trace:
            import torch

            ann = torch.profiler.record_function(f"bench.{name}")
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)
            if ann is not None:
                ann.__exit__(None, None, None)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Record a span around every call of obj.attr (an instance
        attribute that shadows the method; `del obj.attr` unwraps)."""
        fn = getattr(obj, attr)

        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(obj, attr, spanned)

    def mean_ms(self, name: str):
        xs = self.spans.get(name)
        return 1e3 * sum(xs) / len(xs) if xs else None
