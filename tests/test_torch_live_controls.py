"""Run control, the step key and the host utilities of the port, against the
JAX package where it has a counterpart.

* pause, step and start_paused (the JAX package's
  tests/test_round2_features.py:224-273) through a port pipeline and a JAX
  pipeline on the same JAX-rendered 80x60 frames: the frames processed,
  dropped and entered, and the candidate edges with their decisions, are
  equal after every call. While paused no group of tpu_frames_per_step
  frames forms: a step processes one frame.
* device_step.step_key: every value of GraphManager._step_cfg() is in it,
  so changing any parameter behind the step configuration (or the
  extractor's FAST threshold) changes the key; on the card a changed key
  is a new CUDA graph (the card test is in tests/test_torch_manager.py).
* utils.timing and utils.logsetup: the JAX package's names, statistics and
  log lines; utils.roofline's table on the CPU (its device figures come
  from chip_smoke.py phase 18).
"""
import io
import logging

import numpy as np
import pytest

pytest.importorskip("jax")
from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld  # noqa: E402
from rgbdslam_v2_tpu.io import render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu.utils import logsetup as jlogsetup  # noqa: E402
from rgbdslam_v2_tpu.utils import timing as jtiming  # noqa: E402
from rgbdslam_v2_tpu_torch.config import PARAM_DEFS, ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.device_step import step_key  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.utils import logsetup, timing  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

# tests/test_torch_viewer_html.py's camera and parameters: the JAX package
# compiles the same step for both files
CAM = (65.0, 65.0, 40.0, 30.0, 80, 60)
PARAMS = dict(max_keypoints=64, tpu_max_nodes=16, tpu_max_edges=64, tpu_candidate_batch=2,
              ransac_iterations=32, min_matches=8, keep_all_nodes=True,
              observability_threshold=0.5)


@pytest.fixture(scope="module")
def frames():
    world = JWorld.create(seed=0, texture_size=128, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, 6, seed=1)
    return np.asarray(poses), np.asarray(rgbs), np.asarray(depths), np.arange(6) / 30.0


def _pipelines(**over):
    return (JPipeline(JIntrinsics(*CAM), JParams({**PARAMS, **over})),
            SlamPipeline(Intrinsics(*CAM), ParameterServer({**PARAMS, **over}), device="cpu"))


def _state(pipe):
    """(processed, dropped, nodes, [(candidate pair, active, type)]) after a
    blocking drain."""
    mgr = pipe.manager
    mgr._drain_pending()
    h = getattr(mgr, "host", mgr)
    active = h.edge_active if hasattr(h, "edge_active") else h.edge_active_host
    edges = [(pair, bool(active[e]), h.edge_types[e]) for e, pair in enumerate(h.edge_pairs)
             if pair is not None]
    return pipe.n_processed, pipe.n_dropped, mgr.n_nodes, edges


def test_pause_and_step_equal_jax(frames):
    """JAX test_pause_and_step: paused, run_arrays processes nothing; a step
    processes exactly one frame; unpaused, the rest runs."""
    poses, rgbs, depths, stamps = frames
    states = {}
    for name, pipe in zip(("jax", "torch"), _pipelines()):
        assert pipe.toggle_pause() is True
        out = []
        pipe.run_arrays(rgbs[:4], depths[:4], stamps[:4], gt_poses=poses)
        out.append(_state(pipe))
        pipe.get_one_frame()
        pipe.run_arrays(rgbs[:4], depths[:4], stamps[:4], gt_poses=poses)
        out.append(_state(pipe))
        assert pipe.toggle_pause() is False
        pipe.run_arrays(rgbs[2:6], depths[2:6], stamps[2:6], gt_poses=poses)
        out.append(_state(pipe))
        states[name] = out
    assert states["torch"] == states["jax"]
    assert [s[:3] for s in states["torch"]] == [(0, 0, 0), (1, 0, 1), (5, 0, 5)]
    assert any(on and t >= 0 for _, on, t in states["torch"][2][3])  # visual edges accepted


def test_pause_and_step_under_the_delta_wire(frames):
    """tpu_wire_delta with P wires flowing: a frame dropped while paused, or
    passed over after a step, does not move the host mirror of the card's
    codes, so the frames after it decode as if it had never come. The
    paused run's poses are bitwise those of an unpaused run of the kept
    frames (the same step calls), and its counts and decisions are the JAX
    pipeline's, which encodes a delta wire only at dispatch."""
    poses, rgbs, depths, stamps = frames
    over = dict(tpu_wire_delta=True, tpu_wire_delta_max_clamp=1.0, tpu_frames_per_step=2)
    wires = []

    def feed(pipe, ks, gt=False):
        pipe.run_arrays(rgbs[ks], depths[ks], stamps[ks], gt_poses=poses[ks] if gt else None)

    states = {}
    for name, pipe in zip(("jax", "torch"), _pipelines(**over)):
        if name == "torch":
            encode = pipe.manager.encode

            def counted(*a, encode=encode, **kw):
                wire = encode(*a, **kw)
                wires.append(len(wire))
                return wire

            pipe.manager.encode = counted
        feed(pipe, [0, 1], gt=True)
        pipe.toggle_pause()
        feed(pipe, [2, 3])  # both dropped
        pipe.get_one_frame()
        feed(pipe, [4, 5])  # 4 runs, 5 is dropped
        pipe.toggle_pause()
        feed(pipe, [2, 3])  # one group of two P wires
        states[name] = _state(pipe)
    assert states["torch"] == states["jax"]
    assert states["torch"][:3] == (5, 0, 5)
    mgr = pipe.manager
    # frame 0 and frame 1 ship I wires, every later encode a P wire, the
    # dropped frames' included (8 encodes for 8 frames offered)
    assert len(wires) == 8 and wires[0] == wires[1] and max(wires[2:]) < wires[1]

    ref = SlamPipeline(Intrinsics(*CAM), ParameterServer({**PARAMS, **over}), device="cpu")
    for ks, gt in (([0, 1], True), ([4], False), ([2, 3], False)):
        feed(ref, ks, gt)
    assert _state(ref) == states["torch"]
    np.testing.assert_array_equal(mgr.trajectory()[1], ref.manager.trajectory()[1])


def test_start_paused_equals_jax(frames):
    """JAX test_start_paused: nothing processes until a step, the step is
    consumed, and the pipeline stays paused."""
    poses, rgbs, depths, stamps = frames
    states = {}
    for name, pipe in zip(("jax", "torch"), _pipelines(start_paused=True)):
        assert pipe.paused
        took = [pipe.process_frame(rgbs[0], depths[0], 0.0, gt_pose=poses[0])]
        pipe.get_one_frame()
        took += [pipe.process_frame(rgbs[k], depths[k], stamps[k], gt_pose=poses[0])
                 for k in (0, 1)]
        assert pipe.paused
        states[name] = (took, _state(pipe))
    assert states["torch"] == states["jax"] == ([False, True, False], (1, 0, 1, []))


def test_paused_grouping_steps_one_frame(frames):
    """tpu_frames_per_step=4: while paused no group forms (JAX
    _run_arrays_loop), so a step processes one frame, not a group."""
    poses, rgbs, depths, stamps = frames
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer({**PARAMS, "tpu_frames_per_step": 4}),
                        device="cpu")
    groups = []
    group = pipe._process_group
    pipe._process_group = lambda c, s: (groups.append(len(c)), group(c, s))
    pipe.run_arrays(rgbs[:2], depths[:2], stamps[:2], gt_poses=poses)
    pipe.toggle_pause()
    pipe.get_one_frame()
    pipe.run_arrays(rgbs[2:6], depths[2:6], stamps[2:6])
    assert (pipe.n_processed, pipe.manager.n_nodes, groups) == (3, 3, [])
    pipe.toggle_pause()
    pipe.run_arrays(rgbs[2:6], depths[2:6], stamps[2:6])
    assert (pipe.n_processed, pipe.manager.n_nodes, groups) == (7, 7, [4])


def _changed(default):
    """A value of a parameter's type other than `default`."""
    if isinstance(default, bool):
        return not default
    if isinstance(default, int):
        return default + 1
    if isinstance(default, float):
        return default * 2 + 0.5
    return None


def test_step_key_covers_the_step_configuration():
    """Every parameter whose change changes GraphManager._step_cfg()
    changes step_key; among them the values the JAX package's set_param
    reaches (observability_threshold, the depth range, the matching,
    RANSAC and EMM settings, the motion limits); and so does the
    extractor's FAST threshold."""
    p = ParameterServer(dict(PARAMS))
    mgr = GraphManager(Intrinsics(*CAM), p, device="cpu")
    cfg0 = mgr._step_cfg()
    key0 = step_key(4, 1000, cfg0, None)
    assert step_key(4, 1000, mgr._step_cfg(), None) == key0  # the same settings, one key
    moved = set()
    for d in PARAM_DEFS:
        new = _changed(p[d.name])
        if new is None:
            continue
        old = p[d.name]
        p.set(d.name, new)
        try:
            cfg = mgr._step_cfg()
        finally:
            p.set(d.name, old)
        if any(cfg[k] is not v and cfg[k] != v for k, v in cfg0.items()):
            moved.add(d.name)
            assert step_key(4, 1000, cfg, None) != key0, d.name
    assert {"observability_threshold", "minimum_depth", "maximum_depth", "max_matches",
            "nn_distance_ratio", "ransac_iterations", "max_dist_for_inliers", "min_matches",
            "emm_skip_step", "sigma_depth", "sample_candidates", "refine_iterations",
            "max_translation_meter", "max_rotation_degree", "constant_position_information",
            "use_feature_min_depth", "g2o_transformation_refinement", "tpu_emm_exact"} <= moved
    p.set("tpu_edge_info", "hessian")
    assert step_key(4, 1000, mgr._step_cfg(), None) != key0
    p.set("tpu_edge_info", "scalar")
    cfg = dict(cfg0, extractor=type(mgr.extractor)(**{**vars(mgr.extractor),
                                                      "fast_threshold": 0.03}))
    assert step_key(4, 1000, cfg, None) != key0
    # the group size, the wire length and the delta wire's state
    assert len({key0, step_key(3, 1000, cfg0, None), step_key(4, 999, cfg0, None),
                step_key(4, 1000, cfg0, object())}) == 4
    with pytest.raises(TypeError, match="has no key"):
        step_key(4, 1000, dict(cfg0, table=np.zeros(3)), None)
    # a field of a dataclass that is not a scalar is no key either, unless
    # it follows from the scalars (the ydct spec's tables from its name)
    odd = type(mgr.extractor)(**{**vars(mgr.extractor), "fast_threshold": (0.02, 0.03)})
    with pytest.raises(TypeError, match="OrbExtractor.fast_threshold"):
        step_key(4, 1000, dict(cfg0, extractor=odd), None)
    from rgbdslam_v2_tpu_torch.ops import dct_wire

    keys = [step_key(4, 1000, dict(cfg0, dct=dct_wire.spec(q)), None) for q in ("2.7", "3.1")]
    assert keys[0] != keys[1] and keys[0] == step_key(
        4, 1000, dict(cfg0, dct=dct_wire.spec("2.7")), None)


def test_timing_equals_jax(caplog):
    """ScopedTimer, timing_stats and reset_timing_stats: the JAX package's
    statistics keys and its "timings" log line."""
    for mod in (timing, jtiming):
        mod.reset_timing_stats()
        with caplog.at_level(logging.INFO, logger="rgbdslam.timings"):
            caplog.clear()
            with mod.ScopedTimer("node_comparison", verbose=True) as t:
                pass
            with mod.ScopedTimer("node_comparison", min_time_reported=-1):
                pass
        assert t.elapsed >= 0
        st = mod.timing_stats()
        assert list(st) == ["node_comparison"]
        assert sorted(st["node_comparison"]) == ["count", "max_s", "mean_s", "total_s"]
        assert st["node_comparison"]["count"] == 2
        msgs = [(r.name, r.getMessage().split(" took ")[0]) for r in caplog.records]
        assert msgs == [("rgbdslam.timings", "node_comparison")]
        mod.reset_timing_stats()
        assert mod.timing_stats() == {}


def test_logsetup_equals_jax():
    assert logsetup.NAMES == jlogsetup.NAMES
    for name in ("rgbdslam", "graph", "rgbdslam.eval", "timings"):
        assert logsetup.get_logger(name) is jlogsetup.get_logger(name)
    root = logging.getLogger("rgbdslam")
    saved = (root.level, list(root.handlers), logging.getLogger("rgbdslam.timings").level)
    try:
        outs = []
        for mod in (logsetup, jlogsetup):
            root.handlers.clear()
            buf = io.StringIO()
            assert mod.configure_logging(logging.INFO, stream=buf) is root
            assert logging.getLogger("rgbdslam.timings").level == logging.WARNING
            mod.get_logger("statistics").info("nodes %d", 7)
            outs.append(buf.getvalue().split("] ", 1))
        assert outs[0][1] == outs[1][1] == "nodes 7\n"
        assert outs[0][0].endswith("rgbdslam.statistics INFO")
        assert outs[1][0].endswith("rgbdslam.statistics INFO")
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
        logging.getLogger("rgbdslam.timings").setLevel(saved[2])


def test_roofline_report_on_the_cpu(frames):
    """utils/roofline.py at the test's size on the CPU: the five stages,
    host-timed (marked, no device activity here), their bytes and the
    match stage's float operations counted, the bound from the H100 peaks;
    the JAX package's roofline is TPU-only and has no CPU counterpart to
    hold it to."""
    from rgbdslam_v2_tpu_torch.utils import roofline

    poses, rgbs, depths, stamps = frames
    pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(PARAMS)), device="cpu")
    pipe.run_arrays(rgbs[:3], depths[:3], stamps[:3], gt_poses=poses)
    out = io.StringIO()
    rows = roofline.report(pipe.manager, rgbs[3], depths[3], n_steps=1, out=out, tag="[t]")
    assert [r[0] for r in rows] == ["extract", "match", "ransac", "emm", "compare_fused"]
    for name, ms, flops, moved, bound, by, host in rows:
        assert host and ms > 0 and moved > 0 and bound > 0 and by in ("bytes", "operations")
    assert rows[1][2] > 0  # the Hamming matmul
    text = out.getvalue()
    assert "[t] per-frame step stages (cpu; peaks 3.35 TB/s, 67 TFLOP/s float32)" in text
    assert text.count("\n") == 8
