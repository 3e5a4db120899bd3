"""The device trace of a traced run: torch.profiler over one segment of the
cell's own work, reduced to the device's busy time (the union of its
activities' intervals, as ``tools/profile_torch_port.busy_ms`` computes
it), the time of each kernel by name, and the idle gaps named by the
benchmark span the host was in."""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Profile:
    window_s: float  # host clock over the segment, ended by a synchronize
    busy_s: float  # union of the device activities' intervals
    kernels: Dict[str, Tuple[int, float]]  # name -> (count, device seconds)
    gaps: List[Tuple[str, float]]  # the longest idle gaps: (host span, seconds)


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _device_events(prof):
    """The device's activities (kernels, copies, sets), without the
    benchmark's own annotations that the profiler mirrors on the device's
    timeline."""
    return [e for e in prof.events()
            if e.device_type.name == "CUDA" and not e.name.startswith("bench.")]


def profile(fn, n_gaps: int = 10) -> Profile:
    """Run fn() under torch.profiler (host and device activities) and
    reduce its trace. Times in the trace are microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    dev = _device_events(prof)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    kernels = defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) * 1e-6
    # idle gaps between merged device intervals, named by the innermost
    # benchmark span (bench.*) that covers the gap's midpoint
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    host = sorted(((e.time_range.start, e.time_range.end, e.name[6:]) for e in prof.events()
                   if e.device_type.name == "CPU" and e.name.startswith("bench.")),
                  key=lambda x: x[1] - x[0])
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        label = next((n for s, e, n in host if s <= mid <= e), "host")
        gaps.append((label, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Profile(window_s=window_s, busy_s=union_s(spans) * 1e-6,
                   kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                   gaps=gaps[:n_gaps])


def device_ms_per_call(fn, calls: int) -> float:
    """Mean device milliseconds of one fn() call: the summed durations of
    the device activities that a trace of `calls` calls records (as the
    port's utils/roofline.device_ms sums them). None where the trace holds
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = _device_events(prof)
    if not dev:
        return None
    return sum(e.time_range.end - e.time_range.start for e in dev) * 1e-3 / calls


def breakdown(p: Profile) -> dict:
    """The result line's breakdown: the 10 device operations that took
    most time and the 10 longest idle gaps, in seconds."""
    ops = sorted(((k, v[1]) for k, v in p.kernels.items()), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[short_name(k), s] for k, s in ops],
            "idle_gaps": [[n, s] for n, s in p.gaps]}


def short_name(kernel: str, limit: int = 120) -> str:
    """A kernel's name without its template arguments' bodies, cut to `limit`."""
    out, depth = [], 0
    for ch in kernel:
        if ch == "<":
            depth += 1
            if depth == 1:
                out.append("<..>")
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:limit]


def kernel_mean_s(p: Profile, needle: str):
    """Mean device seconds a launch of the kernels whose name holds
    `needle`; None where the trace holds none."""
    n, t = 0, 0.0
    for name, (c, s) in p.kernels.items():
        if needle in name:
            n += c
            t += s
    return t / n if n else None
