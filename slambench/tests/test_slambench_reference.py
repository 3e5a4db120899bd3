"""The frozen renderer equals the port's at this commit, and the plain
reference agrees with the port's own plain (CPU) paths at a tiny size:
matching, the registration's final gate and edge information, the pose
graph's optimum."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny  # noqa: F401
from lib import render
from reference import pose_graph, registration, se3


def test_frozen_renderer_equals_the_ports():
    from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
    from rgbdslam_v2_tpu_torch.io import synthetic

    cam = render.Camera(517.3 / 8, 516.5 / 8, 318.6 / 8, 255.3 / 8, 80, 60)
    icam = Intrinsics(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=80, height=60)
    world = render.World.create(11)
    port_world = synthetic.SyntheticWorld.create(seed=11, cam=icam)
    assert np.array_equal(world.textures, port_world.textures)
    assert world.boxes == port_world.boxes
    poses = world.orbit(20, 13, 0.73, "cpu")
    port_poses = port_world.orbit_trajectory(20, seed=13, deg_per_frame=0.73, device="cpu")
    assert torch.equal(poses, port_poses)
    gen = torch.Generator()
    gen.manual_seed(13)
    frames = list(render.render_frames(world, poses, cam, 0.01, gen))
    pp, prgb, pdepth = synthetic.render_sequence(port_world, 20, seed=13, depth_noise_sigma=0.01,
                                                 device="cpu", trajectory=port_poses)
    assert np.array_equal(torch.cat([f[1] for f in frames]).numpy(), prgb)
    assert np.array_equal(torch.cat([f[2] for f in frames]).numpy(), pdepth)


@pytest.mark.parametrize("binary", [True, False])
def test_matching_equals_the_ports(binary):
    from rgbdslam_v2_tpu_torch.ops.matching import match_descriptors

    rng = np.random.default_rng(3)
    K, D = 96, 256 if binary else 128
    if binary:
        a = np.where(rng.random((K, D)) < 0.5, 1, -1).astype(np.int8)
        b = a.copy()
        flip = rng.random((K, D)) < 0.15
        b[flip] = -b[flip]
        b = b[rng.permutation(K)]
    else:
        a = rng.random((K, D)).astype(np.float32)
        b = (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)[rng.permutation(K)]
    va, vb = rng.random(K) < 0.9, rng.random(K) < 0.9
    m = match_descriptors(torch.from_numpy(a), torch.from_numpy(va), torch.from_numpy(b)[None],
                          torch.from_numpy(vb)[None], 60, 0.9)
    keep = m.valid[0].numpy()
    q, t, _ = registration.match(a.astype(np.float64), va, b.astype(np.float64), vb, 60, 0.9,
                                 binary)
    assert np.array_equal(m.src_idx[0].numpy()[keep], q)
    assert np.array_equal(m.dst_idx[0].numpy()[keep], t)


def _correspondences(rng, M=200, outliers=0.3):
    z = rng.uniform(1.0, 3.5, M)
    uv = rng.uniform([0, 0], [640, 480], (M, 2))
    src = np.stack([(uv[:, 0] - 319.5) * z / 525.0, (uv[:, 1] - 239.5) * z / 525.0, z], -1)
    T = se3.exp(np.array([0.03, -0.02, 0.05, 0.01, -0.02, 0.015]))
    dst = se3.apply(T, src) + rng.normal(0, 0.004, (M, 3)) * z[:, None] ** 2 / 4
    bad = rng.random(M) < outliers
    dst[bad] += rng.uniform(-0.5, 0.5, (bad.sum(), 3))
    return src, dst, rng.uniform(0, 1, M)


def test_edge_information_equals_the_ports_final_gate():
    """The port's RANSAC (plain path) on one candidate: the information
    its step would store, n_inliers / max(rmse^2, 1e-4), equals the
    reference's gate at the port's transform."""
    from rgbdslam_v2_tpu_torch.ops.registration import ransac_register

    rng = np.random.default_rng(5)
    src, dst, dist = _correspondences(rng)
    gen = torch.Generator()
    gen.manual_seed(1)
    res = ransac_register(gen, torch.tensor(src[None], dtype=torch.float32),
                          torch.tensor(dst[None], dtype=torch.float32),
                          torch.tensor(dist[None], dtype=torch.float32),
                          torch.ones((1, len(src)), dtype=torch.bool), cam_fx=525.0, cam_fy=525.0,
                          n_hypotheses=200, refine_iterations=4)
    info = float(res.n_inliers[0]) / max(float(res.rmse[0]) ** 2, 1e-4)
    cfg = {"fx": 525.0, "fy": 525.0, "sigma_depth": 0.01, "max_dist_for_inliers": 3.0}
    ref = registration.edge_information(res.transform[0].double().numpy(),
                                        src.astype(np.float32).astype(np.float64),
                                        dst.astype(np.float32).astype(np.float64), cfg)
    assert abs(info - ref) / ref < 1e-4
    # the reference's own RANSAC finds the same consensus within the noise
    T, inl = registration.register(src, dst, dist, np.random.default_rng(0), fx=525.0, fy=525.0,
                                   sigma_depth=0.01, n_hypotheses=500, sample_size=4,
                                   max_mahal_sq=9.0, refine_iterations=4)
    assert registration.transform_gap(res.transform[0].double().numpy(), T, src[inl]) < 2e-3


def test_pose_graph_optimum_equals_the_ports():
    """The port's LM (plain, float32, run to its stopping rule) on a small
    loop graph lands on the reference's float64 optimum: its cost excess is
    at float32 level, and the reference in bfloat16 is far above it."""
    from rgbdslam_v2_tpu_torch.optim.pose_graph import make_graph_state, optimize
    from reference.precision import bf16

    rng = np.random.default_rng(2)
    n = 40
    ang = 2 * np.pi * np.arange(n) / n
    gt = np.stack([se3.exp(np.array([0, 0, 0, 0, 0, a])) for a in ang])
    gt[:, :3, 3] = np.stack([3 + 1.3 * np.cos(ang), 2.5 + 1.1 * np.sin(ang), 1.5 + 0 * ang], -1)
    I = np.array([k for k in range(1, n) for d in (1, 2, 5) if k - d >= 0] + [n - 1])
    J = np.array([k - d for k in range(1, n) for d in (1, 2, 5) if k - d >= 0] + [0])
    I, J = J, I  # edges (older, newer) as the graph stores them
    Z = se3.inv(gt[I]) @ gt[J] @ se3.exp(rng.normal(0, 0.003, (len(I), 6)))
    info = np.eye(6)[None] * rng.uniform(50, 300, len(I))[:, None, None]
    init = gt @ se3.exp(rng.normal(0, 0.01, (n, 6)))
    init[0] = gt[0]
    g = make_graph_state(n, len(I), device="cpu")
    g.poses.copy_(torch.tensor(init, dtype=torch.float32))
    g.node_active.fill_(True)
    g.node_fixed[0] = True
    g.edge_i.copy_(torch.tensor(I, dtype=torch.int32))
    g.edge_j.copy_(torch.tensor(J, dtype=torch.int32))
    g.edge_meas.copy_(torch.tensor(Z, dtype=torch.float32))
    g.edge_info.copy_(torch.tensor(info, dtype=torch.float32))
    g.edge_active.fill_(True)
    optimize(g, iterations=40, solver="dense")
    graph = {"edge_i": I, "edge_j": J, "edge_meas": Z.astype(np.float32),
             "edge_info": info.astype(np.float32), "edge_active": np.ones(len(I), bool)}
    fixed = np.zeros(n, bool)
    fixed[0] = True
    ex, best = pose_graph.excess(g.poses.double().numpy(), graph, fixed, 1.0)
    assert 0 <= ex < 1e-3
    assert np.abs(best[:, :3, 3] - g.poses.double().numpy()[:, :3, 3]).max() < 1e-3
    ctl, _ = pose_graph.excess(g.poses.double().numpy(), graph, fixed, 1.0, rnd=bf16)
    assert ctl > 30 * max(ex, 1e-6)


def _frames(n: int = 2, W: int = 160, H: int = 120):
    scale = W / 640.0
    cam = render.Camera(517.3 * scale, 516.5 * scale, 318.6 * scale, 255.3 * scale, W, H)
    rgb = np.empty((n, H, W, 3), np.uint8)
    d16 = np.empty((n, H, W), np.uint16)
    render.render_into(rgb, d16, 16, 2, 5, cam, 0.73, 0.01, "cpu")
    return cam, rgb, d16


@pytest.mark.parametrize("name", ["orb_keepall", "siftgpu_eval"])
def test_wire_and_extraction_equal_the_ports(name):
    """The reference's wire delivers the port's grey within 1 level on a
    few pixels (its encoder rounds ties as the port's native one may not)
    and its depth to rounding; its extraction from them finds the port's
    keypoints, descriptors and points (the port's plain CPU path)."""
    from lib import spec
    from reference import features, wire
    from rgbdslam_v2_tpu_torch.config import ParameterServer
    from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
    from rgbdslam_v2_tpu_torch.graph.ingest import unpack_yc12
    from rgbdslam_v2_tpu_torch.graph.manager import GraphManager

    cfg = spec.load_json(spec.ROOT / f"slambench/configs/{name}.json")
    cam, rgb, d16 = _frames()
    cfg["camera"] = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                         height=cam.height)
    cfg["params"].update(max_keypoints=200, tpu_max_nodes=8, tpu_max_edges=64)
    mgr = GraphManager(Intrinsics(**cfg["camera"]), ParameterServer(dict(cfg["params"])),
                       device="cpu")
    binary = cfg["descriptor"] == "binary"
    for i in range(len(rgb)):
        packed = mgr.encode(rgb[i], d16[i])
        g8, dm, _ = unpack_yc12(torch.as_tensor(packed), cam.height, cam.width,
                                mgr.emm_stride, mgr.depth_bits, mgr.dct)
        gray, depth = wire.frame(rgb[i], d16[i], cfg["params"])
        assert np.abs(gray.astype(int) - g8.numpy()).max() <= 1
        assert (gray != g8.numpy()).mean() < 1e-3
        assert np.abs(depth - dm.numpy()).max() < 1e-6
        kp = mgr._extract(mgr._to_device(packed))[0]
        prog = {"uv": kp.uv.numpy(), "xyz": kp.xyz.numpy(), "desc": kp.desc.float().numpy(),
                "valid": kp.valid.numpy()}
        c = features.compare(prog, features.extract(g8.numpy(), dm.numpy(), cfg), binary)
        assert kp.valid.sum() > 50 and c["missing"] == 0.0
        assert c["desc"].max() < (1e-12 if binary else 1e-3) and c["xyz"].max() < 1e-6


def test_brief_pattern_equals_the_ports():
    from reference import features
    from rgbdslam_v2_tpu_torch.ops import orb

    cells = features.brief_pattern()
    assert np.array_equal(cells[:, 0], orb.BRIEF_P_CELLS)
    assert np.array_equal(cells[:, 1], orb.BRIEF_Q_CELLS)


def test_refit_gap_sees_a_moved_transform():
    """The refit of a transform's own inliers leaves a fitted transform
    where it is and pulls a moved one back."""
    rng = np.random.default_rng(3)
    src = np.column_stack([rng.uniform(-1, 1, (200, 2)), rng.uniform(1.0, 3.0, 200)])
    T = se3.exp(np.array([0.05, -0.02, 0.01, 0.01, 0.02, -0.015]))
    dst = se3.apply(T, src)
    cfg = {"fx": 517.3, "fy": 516.5, "sigma_depth": 0.01, "max_dist_for_inliers": 3.0}
    assert registration.refit_gap(T, src, dst, cfg) < 1e-9
    moved = T.copy()
    moved[:3, 3] += 0.005
    assert registration.refit_gap(moved, src, dst, cfg) > 1e-3


@pytest.mark.parametrize("z", [0.25, 0.45, 1.5])
def test_mahalanobis_equals_the_ports_near_and_far(z):
    """The squared Mahalanobis distance equals the port's, also below
    ~0.55 m, where the determinant of both points' covariance falls under
    the system's floor of 1e-18."""
    from rgbdslam_v2_tpu_torch.core.noise import point_covariance_diag
    from rgbdslam_v2_tpu_torch.ops.registration import mahalanobis_sq

    rng = np.random.default_rng(9)
    src = np.column_stack([rng.uniform(-0.1, 0.1, (64, 2)) * z, np.full(64, z)])
    T = se3.exp(np.array([0.001, -0.002, 0.003, 0.002, -0.001, 0.004]))
    dst = se3.apply(T, src) + rng.normal(0, 1e-3 * z, src.shape)
    src32, dst32, T32 = (torch.tensor(a, dtype=torch.float32) for a in (src, dst, T))
    prog = mahalanobis_sq(T32[None], src32[None], dst32[None],
                          point_covariance_diag(src32[None, :, 2], 517.3, 516.5, 0.01),
                          point_covariance_diag(dst32[None, :, 2], 517.3, 516.5, 0.01))[0]
    s, d = src32.double().numpy(), dst32.double().numpy()
    ref = registration.mahalanobis_sq(T32.double().numpy(), s, d,
                                      registration.point_cov(s[:, 2], 517.3, 516.5, 0.01),
                                      registration.point_cov(d[:, 2], 517.3, 516.5, 0.01))
    np.testing.assert_allclose(prog.double().numpy(), ref, rtol=2e-3, atol=1e-6)
