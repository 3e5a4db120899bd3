"""Spans, latencies and ScopedTimer over one process-wide registry.

Port of ``rgbdslam_v2_tpu/utils/timing.py`` (``ScopedTimer``,
``timing_stats``, ``reset_timing_stats``: the same names, statistics keys
and "timings" log line), grown into the port's tracing.

Capability parity: the reference's ScopedTimer logs any scope whose runtime
exceeds `min_time_reported` to the named "timings" logger
(reference: src/scoped_timer.{h,cpp}; param parameter_server.cpp:164), and
the evaluation harness scrapes those lines (summarize_evaluation.sh:60-88).
Here every span logs so, and the registry also accumulates, always on:

* ``span(name, id=None)``, a context manager. Each thread keeps a stack of
  its open spans, so a span knows its parent on its own thread (a span on
  the encode-ahead thread is never a child of one on the main thread). Per
  name: count, total, max and self time (the span's duration less its
  children's), and per parent name the count and total. A thread writes
  its own spans' aggregates, without a lock; reads merge every thread's,
  exactly once the threads are idle.
* ``begin(name)`` / ``end(token)``: a latency that opens in one call and
  closes in another, on any thread. Per name: the same aggregates (self
  time is the total) and the newest ``LATENCY_SAMPLES`` durations.
* While a torch profiler records (anywhere in the process), a span also
  opens a profiler range ``slam.<name>``, with ``id`` in its args (kept
  where the profiler records shapes), on the kernels' timeline; latencies
  open none. Spans and latencies that run while a profiler records are
  left out of the registry: profiled work runs slower. The range is a
  function-scope RecordFunction (``_RecordFunctionFast``): the profiler
  mirrors user-scope ranges (``torch.profiler.record_function``) onto the
  device's timeline, where they would count as device activity.

``timing_stats`` reads count, total, max and mean per name;
``span_stats`` adds self time, parents and latencies.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from time import perf_counter
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler

# the newest durations a latency keeps, for its median and tails
LATENCY_SAMPLES = 65536

_RANGE = torch._C._profiler._RecordFunctionFast
_LOCAL = threading.local()  # .rec: this thread's _Thread
_LOCK = threading.Lock()  # guards what follows
_THREADS: list = []  # the _Thread of every live thread that opened a span
_SHARED: Dict[str, list] = {}  # name -> aggregates of exited threads and latencies
_LATENCIES: Dict[str, deque] = {}  # name -> its newest durations
_MIN_TIME: Optional[float] = None

_logger = logging.getLogger("rgbdslam.timings")


def _min_time() -> float:
    """The reference's min_time_reported (negative = report nothing,
    parameter_server.cpp:164 / scoped_timer.cpp:22-33), read once from the
    process's default parameters."""
    global _MIN_TIME
    if _MIN_TIME is None:
        from ..config import default_params

        m = default_params()["min_time_reported"]
        _MIN_TIME = float("inf") if m < 0 else float(m)
    return _MIN_TIME


def _new(name: str, stats: dict) -> list:
    # count, total, max, self, {parent name: [count, total]}
    st = stats[name] = [0, 0.0, 0.0, 0.0, {}]
    return st


def _merge(dst: dict, src: dict) -> None:
    for name, (n, total, mx, self_s, parents) in list(src.items()):
        st = dst.get(name) or _new(name, dst)
        st[0] += n
        st[1] += total
        st[2] = max(st[2], mx)
        st[3] += self_s
        for p, (pn, pt) in list(parents.items()):
            pc = st[4].setdefault(p, [0, 0.0])
            pc[0] += pn
            pc[1] += pt


class _Thread:
    """One thread's open spans and its spans' aggregates."""

    __slots__ = ("stack", "stats", "thread")

    def __init__(self):
        self.stack: list = []
        self.stats: Dict[str, list] = {}
        self.thread = threading.current_thread()


def _this_thread() -> _Thread:
    """Register the calling thread (min_time_reported is read before its
    first span closes); the aggregates of threads that have ended move to
    _SHARED, so the list holds live threads only."""
    _min_time()
    rec = _LOCAL.rec = _Thread()
    with _LOCK:
        for old in [t for t in _THREADS if not t.thread.is_alive()]:
            _THREADS.remove(old)
            _merge(_SHARED, old.stats)
        _THREADS.append(rec)
    return rec


class span:
    """``with span("drain.wait"): ...``: a span of this thread, nested in
    the span it opens inside; ``elapsed`` holds its duration once it has
    closed. Durations over `min_time` (None: min_time_reported) log to
    "rgbdslam.timings"."""

    __slots__ = ("name", "id", "elapsed", "_t0", "_child", "_range", "_rec")
    min_time: Optional[float] = None

    def __init__(self, name: str, id: Optional[int] = None):
        self.name = name
        self.id = id

    # the defaults bind module names as locals: a span costs ~2 us
    def __enter__(self, _prof=_profiler, _local=_LOCAL, _clock=perf_counter):
        self._range = None
        if _prof._is_profiler_enabled:
            self._range = (_RANGE("slam." + self.name) if self.id is None
                           else _RANGE("slam." + self.name, (), {"id": int(self.id)}))
            self._range.__enter__()
        try:
            rec = _local.rec
        except AttributeError:
            rec = _this_thread()
        self._rec = rec
        rec.stack.append(self)
        self._child = 0.0
        self._t0 = _clock()
        return self

    def __exit__(self, et, ev, tb, _prof=_profiler, _clock=perf_counter):
        el = self.elapsed = _clock() - self._t0
        stack = self._rec.stack
        stack.pop()
        parent = None
        if stack:
            up = stack[-1]
            up._child += el
            parent = up.name
        if self._range is not None:
            self._range.__exit__(None, None, None)
        elif not _prof._is_profiler_enabled:
            stats = self._rec.stats
            st = stats.get(self.name) or _new(self.name, stats)
            st[0] += 1
            st[1] += el
            st[3] += el - self._child
            if el > st[2]:
                st[2] = el
            pc = st[4].get(parent)
            if pc is None:
                pc = st[4][parent] = [0, 0.0]
            pc[0] += 1
            pc[1] += el
        if el > (_MIN_TIME if self.min_time is None else self.min_time):
            _logger.info("%s took %.4f s", self.name, el)
        return False


class ScopedTimer(span):
    """Context manager: `with ScopedTimer("node_comparison"): ...` (a span
    with the reference's options: log over `min_time_reported`, else over
    the parameter's; `verbose` logs every scope)."""

    __slots__ = ("min_time",)

    def __init__(self, name: str, min_time_reported: float | None = None,
                 verbose: bool = False):
        super().__init__(name)
        self.elapsed = 0.0
        self.min_time = None
        if verbose:
            self.min_time = float("-inf")
        elif min_time_reported is not None:
            self.min_time = float("inf") if min_time_reported < 0 else min_time_reported


def begin(name: str) -> tuple:
    """Open latency `name` now; returns its token for end(), which may run
    in another call and on another thread. A token taken while a profiler
    records records nothing."""
    return name, None if _profiler._is_profiler_enabled else perf_counter()


def end(token) -> Optional[float]:
    """Close the latency that begin() opened: its duration in seconds, or
    None (not recorded) for a token of None, one taken while a profiler
    recorded, or while a profiler records."""
    if token is None or token[1] is None or _profiler._is_profiler_enabled:
        return None
    name, t0 = token
    el = perf_counter() - t0
    with _LOCK:
        st = _SHARED.get(name) or _new(name, _SHARED)
        st[0] += 1
        st[1] += el
        st[2] = max(st[2], el)
        st[3] += el
        lat = _LATENCIES.get(name)
        if lat is None:
            lat = _LATENCIES[name] = deque(maxlen=LATENCY_SAMPLES)
        lat.append(el)
    return el


def _merged() -> Dict[str, list]:
    """Every thread's aggregates and the latencies' (the caller holds _LOCK)."""
    out: Dict[str, list] = {}
    _merge(out, _SHARED)
    for rec in _THREADS:
        _merge(out, rec.stats)
    return out


def timing_stats() -> Dict[str, dict]:
    with _LOCK:
        return {
            k: {"count": v[0], "total_s": v[1], "max_s": v[2],
                "mean_s": v[1] / max(v[0], 1)}
            for k, v in _merged().items()
        }


def span_stats() -> Dict[str, dict]:
    """timing_stats() with, per name, `self_s` (the total less the
    children's), `parents` ({parent name, None at the top of a thread:
    {"count", "total_s"}}) and, for a latency, `latencies_s`: its newest
    LATENCY_SAMPLES durations, oldest first."""
    with _LOCK:
        out = {k: {"count": v[0], "total_s": v[1], "max_s": v[2],
                   "mean_s": v[1] / max(v[0], 1), "self_s": v[3],
                   "parents": {p: {"count": n, "total_s": t} for p, (n, t) in v[4].items()}}
               for k, v in _merged().items()}
        for name, lat in _LATENCIES.items():
            out[name]["latencies_s"] = list(lat)
    return out


def reset_timing_stats():
    with _LOCK:
        _SHARED.clear()
        _LATENCIES.clear()
        for rec in _THREADS:
            rec.stats.clear()
