"""Port parity for the wire variants: 6- and 5-bit yc12 luma, the raw wire,
the temporal-delta (P) wire of tpu_wire_delta, and the fallbacks the JAX
GraphManager applies to frame sizes a wire cannot carry.

Bitwise against the JAX package (graph/manager.py): the 6/5-bit and delta
encodes (both packages through native/compact_ingest.cpp; the port's numpy
encoder equal to its native one), the raw encode (the JAX numpy route with
cv2 blocked, as its grey then uses the same fixed-point formula), the device
unpacks (grey, depth, colour and wire codes), the JAX manager's
I-then-P-then-I sequence of _wire_encode, and the first frame's keypoints
where a fallback changes the wire. On the CPU: a 2-frame delta group equals
two 1-frame steps, pose for pose; the step's I/P selection equals the
direct decodes. Each fallback logs the JAX package's warning and ends in
the JAX manager's (format, gray bits, depth bits, delta) and parameters.
"""
import logging
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph import manager as jm  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import ingest  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import manager as tmanager  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
H, W, S = 48, 64, 2
CAM = (50.0, 50.0, W / 2, H / 2, W, H)


def _frame(seed, drift=0, rgb=False):
    """tests/test_wire_delta.py's smooth grey + depth pair (RGB on request:
    the grey in every channel with a per-channel tilt)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    gray = 128 + 80 * np.sin((xx + drift) / 9.0) + 40 * np.cos((yy - drift) / 7.0)
    gray8 = np.clip(gray + rng.normal(0, 1.5, (H, W)), 0, 255).astype(np.uint8)
    d16 = (5000 + 1500 * np.sin((xx + yy + drift) / 11.0)).astype(np.uint16)
    if rgb:
        tilt = np.array([-9, 0, 13])
        gray8 = np.clip(gray8[..., None].astype(int) + tilt, 0, 255).astype(np.uint8)
    return gray8, d16


def _eq(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("bits", [6, 5])
@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("depth_kind", ["u16", "f32"])
def test_gray_bits_wire_matches_jax(bits, rgb, depth_kind):
    g, d = _frame(1, rgb=rgb)
    if depth_kind == "f32":
        d = d.astype(np.float32) / 5000.0
    ingest.reset_encodes()
    got = ingest.compact_frame(g, d, S, 10, None, bits)
    assert ingest.ENCODES == {"native": 1, "numpy": 0}
    ref = jm.compact_frame(g, d, S, fmt="yc12", gray_bits=bits, depth_bits=10)
    _eq(got, ref)
    _eq(ingest.compact_frame_numpy(g, d, S, 10, None, bits), got)
    assert len(got) == ingest.wire_intra_len(H, W, S, bits, 10) == jm.wire_intra_len(
        H, W, S, bits, 10)
    out_t = ingest.unpack_yc12(torch.from_numpy(got), H, W, S, 10, None, bits, return_codes=True)
    out_j = jm._unpack_yc12(jnp.asarray(ref), H, W, S, bits, 10, return_codes=True)
    for a, b in zip(out_t[:3], out_j[:3]):
        _eq(a, b)
    _eq(out_t[3][0], out_j[3][0])
    _eq(out_t[3][1], out_j[3][1])


@pytest.mark.parametrize("rgb", [False, True])
def test_raw_wire_matches_jax(monkeypatch, rgb):
    g, d = _frame(2, rgb=rgb)
    ingest.reset_encodes()
    got = ingest.compact_frame(g, d, S, 12, fmt="raw")
    assert ingest.ENCODES == {"native": 0, "numpy": 1}
    monkeypatch.setitem(sys.modules, "cv2", None)  # JAX grey: the fixed-point formula
    ref = jm.compact_frame(g, d, S, fmt="raw")
    _eq(got, ref)
    gray_t, d16_t, color_t = ingest.unpack_raw(torch.from_numpy(got), H, W, S)
    gray_j, d16_j, color_j = jm._unpack_compact(jnp.asarray(ref), H, W, S)
    _eq(gray_t, gray_j)
    _eq(d16_t, np.asarray(d16_j).astype(np.int32))
    _eq(color_t, color_j)


@pytest.mark.parametrize("drift", [1, 3, 12])
def test_delta_wire_matches_jax(drift):
    """The P wire, the advanced mirrors and the device decode, bitwise;
    drift 12 clamps residuals (a budget of 1.1 keeps it a P wire)."""
    ga, da = _frame(3)
    gb, db = _frame(3, drift=drift, rgb=True)
    intra = ingest.compact_frame(ga, da, S, 10, None, 6)
    qg, qd = ingest.host_unpack_codes(intra, H, W, S)
    jqg, jqd = jm._host_unpack_codes(jm.compact_frame(ga, da, S, gray_bits=6, depth_bits=10),
                                     H, W, S)
    _eq(qg, jqg)
    _eq(qd, jqd)
    np_out = ingest.delta_encode_numpy(gb, db, qg.copy(), qd.copy(), S, 1.1)
    got = ingest.delta_encode(gb, db, qg.copy(), qd.copy(), S, 1.1)
    ref = jm.delta_encode(gb, db, jqg.copy(), jqd.copy(), S, max_clamp=1.1)
    for a, b, c in zip(got, ref, np_out):
        _eq(a, b)
        _eq(a, c)
    assert len(got[0]) == ingest.wire_delta_len(H, W, S) == jm.wire_delta_len(H, W, S)
    prev_t = (torch.from_numpy(qg), torch.from_numpy(qd.astype(np.int32)))
    out_t = ingest.unpack_yc12_delta(torch.from_numpy(got[0]), H, W, S, prev_t)
    out_j = jm._unpack_yc12_delta(jnp.asarray(ref[0]), H, W, S, (jnp.asarray(jqg),
                                                                  jnp.asarray(jqd)))
    for a, b in zip(out_t[:3], out_j[:3]):
        _eq(a, b)
    _eq(out_t[3][0], got[1])
    _eq(out_t[3][1], got[2])


def test_scene_cut_falls_back_to_i_frame():
    ga, da = _frame(2)
    gb, db = 255 - ga, (12000 - da).astype(np.uint16)  # every luma residual clamps
    qg, qd = ingest.host_unpack_codes(ingest.compact_frame(ga, da, S, 10, None, 6), H, W, S)
    assert ingest.delta_encode(gb, db, qg.copy(), qd.copy(), S, 0.02) is None
    assert ingest.delta_encode_numpy(gb, db, qg, qd, S, 0.02) is None


def test_step_decode_selects_i_and_p(monkeypatch):
    """prepare_and_extract_wire on an I wire, then a P wire padded to the I
    length: the grey and depth it extracts from and the codes it leaves in
    the state equal the JAX decodes (the extractor replaced by a probe)."""
    seen = []
    monkeypatch.setattr(ingest, "finish_yc12",
                        lambda *a: seen.append((a[6].clone(), a[7].clone())) or (None, None))
    ga, da = _frame(4)
    gb, db = _frame(4, drift=1)
    intra = ingest.compact_frame(ga, da, S, 10, None, 6)
    qg, qd = ingest.host_unpack_codes(intra, H, W, S)
    p = ingest.delta_encode(gb, db, qg, qd, S, 0.05)[0]
    cam = Intrinsics(*CAM)
    state = (torch.full((H, W), 9, dtype=torch.uint8),
             torch.full((H // S, W // S), 9, dtype=torch.int32))
    L = len(intra)
    for wire, is_i in ((intra, True), (np.pad(p, (0, L - len(p))), False)):
        ingest.prepare_and_extract_wire(None, cam, S, 0.0, 100.0, False,
                                        torch.from_numpy(wire), torch.tensor(is_i), state)
    gj, dj, _, cj = jm._unpack_yc12(jnp.asarray(intra), H, W, S, 6, 10, return_codes=True)
    gp, dp, _, cp = jm._unpack_yc12_delta(jnp.asarray(p), H, W, S, cj)
    for (g, d), (rg, rd) in zip(seen, ((gj, dj), (gp, dp))):
        _eq(g, rg)
        _eq(d, rd)
    _eq(state[0], cp[0])
    _eq(state[1], np.asarray(cp[1]).astype(np.int32))


def test_manager_i_then_p_matches_jax():
    """tests/test_wire_delta.py:139 through both managers: I, P, I after a
    scene cut, P; bytes equal."""
    params = dict(max_keypoints=64, tpu_max_nodes=8, tpu_max_edges=64, tpu_candidate_batch=2,
                  tpu_wire_delta=True)
    jmgr = jm.GraphManager(JIntrinsics(*CAM), JParams(dict(params)))
    tmgr = tmanager.GraphManager(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    assert tmgr.wire_delta and jmgr.wire_delta
    ga, da = _frame(4)
    gb, db = _frame(4, drift=1)
    gc, dc = 255 - gb, (12000 - db).astype(np.uint16)
    gd, dd = 255 - _frame(4, drift=2)[0], (12000 - _frame(4, drift=2)[1]).astype(np.uint16)
    lens = []
    for g, d in ((ga, da), (gb, db), (gc, dc), (gd, dd)):
        d = d.astype(np.float32) / 5000.0
        got, ref = tmgr._wire_encode(g, d), jmgr._wire_encode(g, d)
        _eq(got, ref)
        lens.append(len(got))
    I, P = ingest.wire_intra_len(H, W, S), ingest.wire_delta_len(H, W, S)
    assert lens == [I, P, I, P]


SMALL = (130.0, 130.0, 80.0, 60.0, 160, 120)
PIPE = dict(max_keypoints=256, tpu_max_nodes=64, tpu_max_edges=512, tpu_candidate_batch=4,
            ransac_iterations=128, min_matches=12, optimizer_skip_step=10, keep_all_nodes=True,
            observability_threshold=0.5, tpu_drain_pipelined=False, tpu_wire_delta=True)


def test_delta_group_equals_single_steps():
    """20 frames with the delta wire, 2 frames a step against 1: the same
    poses (the CPU runs both eagerly: equal to the bit), statistics and
    wires. At 160x120 the orbit's 2 degrees a frame clamp more than the
    default 2% of the residuals, so the default sends I wires only; a
    budget of 0.6 lets P wires through. A budget of 0 sends every frame as
    an I wire and still tracks."""
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*SMALL))
    poses, rgbs, depths = jrender(world, 20, seed=2)
    poses, stamps = np.asarray(poses), np.arange(20) / 30.0
    runs = {}
    for n, clamp in ((1, 0.6), (2, 0.6), (2, 0.0)):
        pipe = SlamPipeline(Intrinsics(*SMALL), ParameterServer(dict(
            PIPE, tpu_frames_per_step=n, tpu_wire_delta_max_clamp=clamp)), device="cpu")
        sizes = []
        encode = pipe.manager.encode
        pipe.manager.encode = lambda *a: sizes.append(len(x := encode(*a))) or x
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        runs[(n, clamp)] = (pipe.manager.poses(), pipe.manager.statistics(), sizes)
    (p1, s1, z1), (p2, s2, z2), (p0, s0, z0) = runs.values()
    np.testing.assert_array_equal(p2, p1)
    assert s2 == s1 and z2 == z1
    I, P = (ingest.wire_intra_len(120, 160, 2), ingest.wire_delta_len(120, 160, 2))
    assert z1[:2] == [I, I] and z1.count(P) >= 10  # frame 0 off the chain, then I, P...
    assert set(z0[1:]) == {I} and s0["nodes"] == 20
    assert np.abs(p0[:, :3, 3] - poses[:, :3, 3]).max() < 0.05


FALLBACKS = {
    # JAX GraphManager.__init__'s fallbacks, at the frame sizes that trigger them
    "ydct_to_yc12": (dict(tpu_ingest_format="ydct"), (100.0, 100.0, 66.0, 50.0, 132, 100)),
    "yc12_to_raw": (dict(tpu_ingest_format="yc12"), (100.0, 100.0, 81.0, 61.0, 162, 122)),
    "ydct_to_raw": (dict(tpu_ingest_format="ydct"), (100.0, 100.0, 82.0, 61.0, 164, 122)),
    "gray5_to_6": (dict(tpu_gray_bits=5, cloud_creation_skip_step=1),
                   (100.0, 100.0, 65.0, 51.0, 130, 102)),
    "delta_off_ydct": (dict(tpu_ingest_format="ydct", tpu_wire_delta=True), SMALL),
    "delta_off_raw": (dict(tpu_wire_delta=True), (100.0, 100.0, 81.0, 61.0, 162, 122)),
    "delta_implies_6_10": (dict(tpu_wire_delta=True, tpu_gray_bits=8, tpu_depth_bits=12),
                           SMALL),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_fallbacks_match_jax(case, caplog):
    over, cam = FALLBACKS[case]
    params = {**PIPE, "tpu_wire_delta": False, **over}
    with caplog.at_level(logging.WARNING):
        jmgr = jm.GraphManager(JIntrinsics(*cam), JParams(dict(params)))
        j_msgs = [r.getMessage() for r in caplog.records]
        caplog.clear()
        tp = ParameterServer(dict(params))
        pipe = SlamPipeline(Intrinsics(*cam), tp, device="cpu")
        t_msgs = [r.getMessage() for r in caplog.records]
    t = pipe.manager
    assert (t.ingest_fmt, t.gray_bits, t.depth_bits, t.wire_delta) == (
        jmgr.ingest_fmt, jmgr.gray_bits, jmgr.depth_bits, jmgr.wire_delta)
    assert (tp["tpu_gray_bits"], tp["tpu_depth_bits"]) == (
        jmgr.params["tpu_gray_bits"], jmgr.params["tpu_depth_bits"])
    head = [m.split(";")[0].split(":")[0] for m in t_msgs]
    assert t_msgs and head == [m.split(";")[0].split(":")[0] for m in j_msgs]
    if case in ("delta_off_ydct", "delta_implies_6_10"):
        return
    # the fallback wire runs: the first frame's keypoints equal the JAX
    # package's on the same frame (grey input: both packages' raw grey)
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*cam))
    gt, rgbs, depths = jrender(world, 3, seed=2)
    gray = ((rgbs.astype(np.uint16) * np.array([77, 150, 29])).sum(-1) >> 8).astype(np.uint8)
    jpipe = jm_pipeline(cam, params)
    for p in (jpipe, pipe):
        p.run_arrays(gray, depths, np.arange(3) / 30.0, gt_poses=np.asarray(gt))
    for name in ("uv", "kp_valid"):
        _eq(getattr(t.store, name)[0], np.asarray(getattr(jpipe.manager.store, name)[0]))
    assert t.n_nodes == jpipe.manager.n_nodes == 3


def jm_pipeline(cam, params):
    from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline

    return JPipeline(JIntrinsics(*cam), JParams(dict(params)))
