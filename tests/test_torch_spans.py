"""The port's spans and latencies (utils/timing.py) and where the program
opens them: nesting and self time on one thread and across threads (a
worker's span is never a main-thread child), the begin/end latency, one
pose_landed sample for every frame that entered (the single pipeline's
keep-all and host-decision paths, and MultiSequenceSlam), the frame's
span at least the sum of its children, profiler ranges opened only while
a profiler records (and then the spans left out of the registry), the
min_time_reported log, and a span's cost. Imports no JAX, so it runs on
the card too:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rgbdslam_v2_tpu_torch import config
from rgbdslam_v2_tpu_torch.config import ParameterServer
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence
from rgbdslam_v2_tpu_torch.parallel.slam_multi import MultiSequenceSlam
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline
from rgbdslam_v2_tpu_torch.utils import timing

torch.set_num_threads(1)
CAM = Intrinsics(130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 14
SMALL = dict(max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=512, tpu_candidate_batch=4,
             ransac_iterations=64, min_matches=12)
# the benchmark's single-pipeline settings: keep-all, ydct, 4 frames a step,
# encode-ahead, pipelined drains, an online optimize every 10 frames
KEEP_ALL = dict(SMALL, keep_all_nodes=True, observability_threshold=0.5,
                optimizer_skip_step=10, pose_relative_to="inaffected", emm_skip_step=4,
                tpu_ingest_format="ydct", tpu_dct_quality="2.7", tpu_gray_bits=8,
                tpu_depth_bits=10, tpu_frames_per_step=4, tpu_encode_ahead=True)


@pytest.fixture(scope="module")
def sequence():
    world = SyntheticWorld.create(seed=0, texture_size=128, cam=CAM)
    poses, rgbs, depths = render_sequence(world, N_FRAMES, seed=2, device="cpu")
    return np.asarray(poses), rgbs, depths, np.arange(N_FRAMES) / 30.0


@pytest.fixture(autouse=True)
def fresh():
    timing.reset_timing_stats()
    yield
    timing.reset_timing_stats()


def test_nesting_and_self_time_on_one_thread():
    with timing.span("outer", 3) as outer:
        time.sleep(0.002)
        with timing.span("inner") as inner:
            time.sleep(0.003)
        with timing.span("inner"):
            pass
    st = timing.span_stats()
    assert st["outer"]["count"] == 1 and st["inner"]["count"] == 2
    assert set(st["outer"]["parents"]) == {None}
    assert st["inner"]["parents"]["outer"]["count"] == 2 and set(st["inner"]["parents"]) == {
        "outer"}
    assert st["outer"]["total_s"] == outer.elapsed >= 0.005
    assert st["outer"]["self_s"] == pytest.approx(outer.elapsed - st["inner"]["total_s"],
                                                  abs=1e-12)
    assert 0.002 <= st["outer"]["self_s"] < outer.elapsed - inner.elapsed
    assert st["inner"]["self_s"] == st["inner"]["total_s"]
    assert st["inner"]["max_s"] == inner.elapsed
    # timing_stats keeps the JAX package's keys
    assert set(timing.timing_stats()["inner"]) == {"count", "total_s", "max_s", "mean_s"}


def test_a_worker_span_is_never_a_main_thread_child():
    with timing.span("main") as main:
        with ThreadPoolExecutor(1) as ex:
            ex.submit(_spanned, "worker", 0.0).result()
            with timing.span("worker_wait"):
                ex.submit(time.sleep, 0.004).result()
            ex.submit(_spanned, "worker", 0.003).result()
    # the worker has ended: its aggregates outlive it, also once another
    # thread registers
    t = threading.Thread(target=_spanned, args=("late", 0.0))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    st = timing.span_stats()
    assert st["worker"]["count"] == 2 and set(st["worker"]["parents"]) == {None}
    assert st["late"]["count"] == 1
    assert set(st["main"]["parents"]) == {None}
    # only the main thread's own child counts against its self time
    assert st["main"]["self_s"] == pytest.approx(
        main.elapsed - st["worker_wait"]["total_s"], abs=1e-12)
    assert st["main"]["self_s"] >= 0.003


def _spanned(name, seconds):
    with timing.span(name):
        time.sleep(seconds)


def test_latency_opens_in_one_call_and_closes_in_another(monkeypatch):
    tokens = [timing.begin("lat") for _ in range(3)]
    time.sleep(0.003)
    with ThreadPoolExecutor(1) as ex:  # closed on another thread
        durations = list(ex.map(timing.end, tokens))
    assert all(d >= 0.003 for d in durations)
    st = timing.span_stats()["lat"]
    assert st["count"] == 3 and st["latencies_s"] == durations
    assert st["total_s"] == pytest.approx(sum(durations)) and st["parents"] == {}
    assert timing.end(None) is None
    # the newest LATENCY_SAMPLES durations are kept, every one counted
    monkeypatch.setattr(timing, "LATENCY_SAMPLES", 4)
    kept = [timing.end(timing.begin("short")) for _ in range(6)]
    st = timing.span_stats()["short"]
    assert st["count"] == 6 and st["latencies_s"] == kept[2:]


def _children_s(st, parent):
    return sum(v["parents"][parent]["total_s"] for v in st.values()
               if parent in v.get("parents", {}))


@pytest.mark.parametrize("params", [KEEP_ALL, SMALL], ids=["keep_all", "host_decisions"])
def test_one_pose_landed_a_frame_that_entered(sequence, params):
    poses, rgbs, depths, stamps = sequence
    pipe = SlamPipeline(CAM, ParameterServer(dict(params)), device="cpu")
    pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    pipe.manager.statistics()  # drain
    st = timing.span_stats()
    n = pipe.manager.n_nodes
    assert n >= 2
    assert st["pose_landed"]["count"] == len(st["pose_landed"]["latencies_s"]) == n
    assert pipe.manager._landing == {}
    assert st["frames"]["total_s"] == pytest.approx(pipe.wall_time)
    assert st["frames"]["total_s"] >= _children_s(st, "frames")
    assert st["frames"]["self_s"] == pytest.approx(
        st["frames"]["total_s"] - _children_s(st, "frames"), abs=1e-9)
    assert st["encode"]["count"] == N_FRAMES
    if params is KEEP_ALL:
        # encodes run ahead on their own thread; groups of 4 on the fast path
        assert set(st["encode"]["parents"]) == {None}
        assert st["encode.wait"]["count"] >= 1
        assert st["frames"]["count"] == 1 + (N_FRAMES - 1) // 4 + (N_FRAMES - 1) % 4
        for name in ("step.inputs", "step.launch"):
            assert set(st[name]["parents"]) == {"frames"}
        assert st["optimize.online"]["count"] == 1
        assert st["drain.apply"]["count"] >= 1
    else:
        assert st["frames"]["count"] == N_FRAMES and "step.launch" not in st


def test_multi_sequence_spans(sequence):
    poses, rgbs, depths, stamps = sequence
    S, T = 2, 6
    ms = MultiSequenceSlam(CAM, S, params=ParameterServer(dict(
        KEEP_ALL, tpu_encode_ahead=False, pose_relative_to="first")), device="cpu")
    for k in range(T):
        cpts = [ms.compact(rgbs[k + s], depths[k + s]) for s in range(S)]
        ms.add_frames(np.stack(cpts), np.full(S, stamps[k]),
                      gt_poses=poses[:S] if k == 0 else None)
        if k == 3:
            ms.optimize(iterations=2, blocking=False)
    ms.statistics()
    st = timing.span_stats()
    assert st["pose_landed"]["count"] == S * T
    assert all(sq._landing == {} for sq in ms.seq)
    assert st["add_frames"]["count"] == T and st["encode"]["count"] == S * T
    assert st["optimize.seq"]["parents"]["optimize.online"]["count"] == S
    assert st["optimize.online"]["total_s"] >= st["optimize.seq"]["total_s"]
    for name in ("step.pack", "step.launch", "step.queued"):
        assert st[name]["count"] == T - 1 and set(st[name]["parents"]) == {"add_frames"}
    assert st["step.inputs"]["count"] == S * (T - 1)


def test_profiler_ranges_only_while_a_profiler_records(monkeypatch, sequence):
    from torch.profiler import ProfilerActivity, profile

    opened = []
    real = timing._RANGE
    monkeypatch.setattr(timing, "_RANGE", lambda *a: opened.append(a[0]) or real(*a))
    with timing.span("off", 1):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with timing.span("probe", 7):
            with timing.span("probe_inner"):
                torch.ones(4).sum()
        token = timing.begin("lat_on")
    assert timing.end(token) is None  # begun under the profiler: not recorded
    assert opened == ["slam.probe", "slam.probe_inner"]
    events = {e.name: e for e in prof.events() if e.name.startswith("slam.")}
    assert set(events) == {"slam.probe", "slam.probe_inner"}
    assert all(e.device_type.name == "CPU" for e in events.values())
    assert events["slam.probe"].kwinputs == {"id": 7}
    st = timing.span_stats()
    assert set(st) == {"off"}  # the profiled spans are left out
    with timing.span("after"):
        pass
    assert timing.span_stats()["after"]["count"] == 1 and len(opened) == 2
    # frames taken while a profiler records land unrecorded on both the
    # single-frame and the group path; a frame handed in with no token
    # opens its own
    poses, rgbs, depths, stamps = sequence
    pipe = SlamPipeline(CAM, ParameterServer(dict(KEEP_ALL)), device="cpu")
    mgr = pipe.manager
    with profile(activities=[ProfilerActivity.CPU]):
        taken = [timing.begin("pose_landed") for _ in range(6)]
    cpts = [mgr.encode(rgbs[k], depths[k]) for k in range(6)]
    pipe.process_frame(None, None, float(stamps[0]), poses[0], compact=cpts[0], token=taken[0])
    pipe.process_frame(None, None, float(stamps[1]), compact=cpts[1], token=taken[1])
    assert mgr.can_group(4)
    mgr.add_frame_group(cpts[2:6], [float(t) for t in stamps[2:6]], tokens=taken[2:6])
    pipe.process_frame(None, None, float(stamps[6]), compact=mgr.encode(rgbs[6], depths[6]))
    mgr.statistics()  # drain
    assert mgr.n_nodes == 7 and mgr._landing == {}
    assert timing.span_stats()["pose_landed"]["count"] == 1


def test_every_program_span_reader_reads_a_tiny_run(sequence, tmp_path):
    """Each of the benchmark's readers of the program's spans
    (slambench/metrics) reads a number from the program's aggregates after a
    tiny single pipeline on each path and a tiny MultiSequenceSlam: all but
    step_bringup_ms, whose CUDA graphs exist on the card only."""
    import importlib.util
    import json
    from pathlib import Path

    poses, rgbs, depths, stamps = sequence
    for params in (KEEP_ALL, SMALL):
        pipe = SlamPipeline(CAM, ParameterServer(dict(params)), device="cpu")
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        pipe.manager.optimize(blocking=True)
        pipe.evaluation_protocol(tmp_path)
    S = 2
    ms = MultiSequenceSlam(CAM, S, params=ParameterServer(dict(
        KEEP_ALL, tpu_encode_ahead=False, pose_relative_to="first")), device="cpu")
    for k in range(11):
        ms.add_frames(np.stack([ms.compact(rgbs[k + s], depths[k + s]) for s in range(S)]),
                      np.full(S, stamps[k]), gt_poses=poses[:S] if k == 0 else None)
        if k % 10 == 9:
            ms.optimize(iterations=2, blocking=False)
    ms.statistics()
    root = Path(__file__).resolve().parents[1] / "slambench"
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    names = [m["name"] for m in spec["per_layer"]
             if "utils import timing" in (root / "metrics" / f"{m['name']}.py").read_text()]
    assert len(names) == 25
    read = {}
    for name in names:
        loader = importlib.util.spec_from_file_location(name, root / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(loader)
        loader.loader.exec_module(mod)
        read[name] = mod.read(None)
    assert read.pop("step_bringup_ms") is None
    assert all(v is not None and 0.0 <= v < float("inf") for v in read.values()), read
    assert read["frames_self_pct"] <= 100.0


def test_spans_log_over_min_time_reported_read_once(monkeypatch, caplog):
    calls = []
    real = config.default_params

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(config, "default_params", counted)
    monkeypatch.setattr(timing, "_MIN_TIME", None)
    monkeypatch.delattr(timing._LOCAL, "rec", raising=False)  # as a new thread
    with caplog.at_level(logging.INFO, logger="rgbdslam.timings"):
        for _ in range(50):
            with timing.ScopedTimer("quiet"):
                pass
        assert len(calls) <= 1  # read at most once: -1 by default, nothing logged
        assert caplog.records == []
        monkeypatch.setattr(timing, "_MIN_TIME", 0.0)
        with timing.span("loud"):
            time.sleep(0.001)
    assert [r.getMessage().split(" took ")[0] for r in caplog.records] == ["loud"]


def test_span_cost():
    """A span costs ~2 us on a CPU with no profiler recording; bounded here
    at ten times that, since the tests share their machine."""
    n, best = 20000, float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(n):
            with timing.span("cost", i):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 20e-6, best
    assert timing.span_stats()["cost"]["count"] == 3 * n
