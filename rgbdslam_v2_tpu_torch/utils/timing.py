"""ScopedTimer: RAII timing with a process-wide stats registry.

Port of ``rgbdslam_v2_tpu/utils/timing.py``: the same code, names and output.

Capability parity: the reference's ScopedTimer logs any scope whose runtime
exceeds `min_time_reported` to the named "timings" logger
(reference: src/scoped_timer.{h,cpp}; param parameter_server.cpp:164), and
the evaluation harness scrapes those lines (summarize_evaluation.sh:60-88).
Here timers also accumulate (count, total, max) per name for programmatic
observability (the statistics the reference only exposed via log scraping).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from typing import Dict

_LOCK = threading.Lock()
_STATS: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])  # count, total, max

_logger = logging.getLogger("rgbdslam.timings")


class ScopedTimer:
    """Context manager: `with ScopedTimer("node_comparison"): ...`"""

    def __init__(self, name: str, min_time_reported: float | None = None,
                 verbose: bool = False):
        self.name = name
        if min_time_reported is None:
            # the reference's min_time_reported param (negative = report
            # nothing, parameter_server.cpp:164 / scoped_timer.cpp:22-33)
            from ..config import default_params

            min_time_reported = default_params()["min_time_reported"]
        self.min_time = (
            float("inf") if min_time_reported < 0 else min_time_reported
        )
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        with _LOCK:
            st = _STATS[self.name]
            st[0] += 1
            st[1] += self.elapsed
            st[2] = max(st[2], self.elapsed)
        if self.verbose or self.elapsed > self.min_time:
            _logger.info("%s took %.4f s", self.name, self.elapsed)
        return False


def timing_stats() -> Dict[str, dict]:
    with _LOCK:
        return {
            k: {"count": v[0], "total_s": v[1], "max_s": v[2],
                "mean_s": v[1] / max(v[0], 1)}
            for k, v in _STATS.items()
        }


def reset_timing_stats():
    with _LOCK:
        _STATS.clear()
