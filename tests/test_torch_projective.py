"""Port parity: the projective refinement of g2o_transformation_refinement
(ops/projective.py: refine_projective, uvz_from_xyz) and ransac_register
with projective_iterations, against the JAX package, on
tests/test_projective.py's far-field scenes (numpy-seeded).

On the CPU: refine_projective's T within 2e-4 of the JAX function's (both
in float32: the einsum and solve orders differ between XLA and torch, and
GN amplifies a last-bit difference over 4-6 iterations; the pose errors
involved are ~1e-3); ransac_register with the JAX hypotheses injected: T
within 2e-4, inlier masks equal except matches within 1e-3 x max_mahal_sq
of the gate, n_inliers off by at most their count. In float64 the plain
version converges and beats the Kabsch refit on rotation as the JAX test
demands.

The `cuda` test holds the refine kernel's projective stage to the plain
version run in float64 on the card (chip_smoke.refine_against_plain's
tolerances); it needs no JAX and runs with
python -m pytest --noconftest -m cuda tests/test_torch_projective.py.
"""
import numpy as np
import pytest
import torch

from rgbdslam_v2_tpu_torch.core import se3
from rgbdslam_v2_tpu_torch.ops import projective, registration

torch.set_num_threads(1)
FX = FY = 525.0
CX, CY = 319.5, 239.5
N_HYP, SAMPLE = 64, 4
GATE = 9.0
KW = dict(cam_fx=FX, cam_fy=FY, n_hypotheses=N_HYP, sample_size=SAMPLE, max_mahal_sq=GATE,
          min_inliers=12, sigma_depth=0.01)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from rgbdslam_v2_tpu.core import se3 as jse3
    from rgbdslam_v2_tpu.ops import projective as jproj
    from rgbdslam_v2_tpu.ops import registration as jreg
    return jax, jnp, jse3, jproj, jreg


def _rot(v):
    th = np.linalg.norm(v)
    k = v / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _far_scene(seed, n=96, z_lo=4.0, z_hi=9.0, sigma_depth=0.01, outliers=0.0):
    """tests/test_projective.py's far field: 0.5 px detection noise, 0.01
    z^2 depth noise in both frames; optionally outliers moved up to 0.5 m.
    Returns (src_uvz, src_xyz, dst_uvz, dst_xyz, T_true) float32."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(z_lo, z_hi, n)
    u, v = rng.uniform(40, 600, n), rng.uniform(40, 440, n)
    src = np.stack([(u - CX) * z / FX, (v - CY) * z / FY, z], -1)
    T = np.eye(4)
    T[:3, :3] = _rot(rng.uniform(-0.15, 0.15, 3))
    T[:3, 3] = rng.uniform(-0.15, 0.15, 3)
    dst = src @ T[:3, :3].T + T[:3, 3]

    def observe(pts):
        uvz = np.stack([FX * pts[:, 0] / pts[:, 2] + CX, FY * pts[:, 1] / pts[:, 2] + CY,
                        pts[:, 2]], -1)
        uvz[:, :2] += rng.normal(0, 0.5, (len(pts), 2))
        uvz[:, 2] += rng.normal(0, sigma_depth, len(pts)) * uvz[:, 2] ** 2
        xyz = np.stack([(uvz[:, 0] - CX) * uvz[:, 2] / FX, (uvz[:, 1] - CY) * uvz[:, 2] / FY,
                        uvz[:, 2]], -1)
        return uvz.astype(np.float32), xyz.astype(np.float32)

    su, sx = observe(src)
    du, dx = observe(dst)
    out = rng.uniform(size=n) < outliers
    dx[out] += rng.uniform(-0.5, 0.5, (int(out.sum()), 3)).astype(np.float32)
    return su, sx, du, dx, T.astype(np.float32)


def _perturbed(T, xi):
    return (se3.exp_se3(torch.tensor(xi, dtype=torch.float64)).numpy() @ T).astype(np.float32)


def _rot_err(T_est, T_true):
    R = T_true[:3, :3].T @ T_est[:3, :3]
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iterations", [1, 4, 6])
def test_refine_projective_matches_jax(jx, seed, iterations):
    jax, jnp, _, jproj, _ = jx
    su, _, du, _, T_true = _far_scene(seed)
    T0 = _perturbed(T_true, [0.03, -0.02, 0.04, 0.01, -0.015, 0.02])
    w = np.ones(len(su), np.float32)
    w[::7] = 0.0  # dropped matches (RANSAC outliers)
    ref = np.asarray(jproj.refine_projective(jnp.asarray(T0), jnp.asarray(su), jnp.asarray(du),
                                             jnp.asarray(w), FX, FY, CX, CY,
                                             iterations=iterations))
    got = projective.refine_projective(torch.from_numpy(T0)[None], torch.from_numpy(su)[None],
                                       torch.from_numpy(du)[None], torch.from_numpy(w)[None],
                                       FX, FY, CX, CY, iterations=iterations)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=0, atol=2e-4)


def test_refine_projective_batch_and_uvz_match_jax(jx):
    """Three candidates in one call, one of them without a weighted match
    (T unchanged); uvz_from_xyz equal to the JAX function's within 1e-4 px."""
    _, jnp, _, jproj, _ = jx
    scenes = [_far_scene(s) for s in (3, 4, 5)]
    T0 = np.stack([_perturbed(s[4], [0.02, 0.01, -0.03, 0.01, 0.01, -0.01]) for s in scenes])
    w = np.ones((3, 96), np.float32)
    w[2] = 0.0
    su, du = np.stack([s[0] for s in scenes]), np.stack([s[2] for s in scenes])
    got = projective.refine_projective(*(torch.from_numpy(a) for a in (T0, su, du, w)),
                                       FX, FY, CX, CY, iterations=4)
    for b in range(3):
        ref = jproj.refine_projective(jnp.asarray(T0[b]), jnp.asarray(su[b]), jnp.asarray(du[b]),
                                      jnp.asarray(w[b]), FX, FY, CX, CY, iterations=4)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), rtol=0, atol=2e-4)
    assert torch.equal(got[2], torch.from_numpy(T0[2]))
    xyz = np.stack([s[1] for s in scenes])
    np.testing.assert_allclose(
        projective.uvz_from_xyz(torch.from_numpy(xyz), FX, FY, CX, CY).numpy(),
        np.asarray(jproj.uvz_from_xyz(jnp.asarray(xyz), FX, FY, CX, CY)), rtol=0, atol=1e-4)


def test_refine_projective_converges_and_beats_kabsch_in_float64():
    """tests/test_projective.py's two claims, on the port's plain version
    in float64: a perturbed start loses half its error; on far noisy depth
    the median rotation gain over the Kabsch refit exceeds 1.2."""
    from rgbdslam_v2_tpu_torch.core.alignment import weighted_kabsch_plain

    su, _, du, _, T_true = _far_scene(0)
    T0 = _perturbed(T_true, [0.03, -0.02, 0.04, 0.01, -0.015, 0.02])
    T = projective.refine_projective(torch.from_numpy(T0).double()[None],
                                     torch.from_numpy(su).double()[None],
                                     torch.from_numpy(du).double()[None],
                                     torch.ones(1, len(su), dtype=torch.float64),
                                     FX, FY, CX, CY, iterations=6)[0].numpy()
    assert _rot_err(T, T_true) < 0.5 * _rot_err(T0, T_true)
    t_err = np.linalg.norm(T[:3, 3] - T_true[:3, 3])
    assert t_err < 0.5 * np.linalg.norm(T0[:3, 3] - T_true[:3, 3])
    gains = []
    for seed in range(6):
        su, sx, du, dx, T_true = _far_scene(seed)
        w = torch.ones(1, len(su), dtype=torch.float64)
        Tk = weighted_kabsch_plain(torch.from_numpy(sx).double()[None],
                                   torch.from_numpy(dx).double()[None], w)
        Tp = projective.refine_projective(Tk, torch.from_numpy(su).double()[None],
                                          torch.from_numpy(du).double()[None], w,
                                          FX, FY, CX, CY, iterations=6)
        gains.append(_rot_err(Tk[0].numpy(), T_true) / max(_rot_err(Tp[0].numpy(), T_true), 1e-9))
    assert np.median(gains) > 1.2, gains


def _jax_indices(jx, seed, dist, valid):
    jax, jnp, _, _, jreg = jx
    M = len(dist)
    mv = jnp.asarray(valid)
    order = jnp.argsort(jnp.where(mv, jnp.asarray(dist), jnp.inf))
    rank = jnp.zeros((M,), jnp.float32).at[order].set(jnp.arange(M, dtype=jnp.float32))
    logits = jnp.where(mv, -rank * (4.0 / M), -jnp.inf)
    return np.asarray(jreg._gumbel_topk_sample(jax.random.PRNGKey(seed), logits, N_HYP, SAMPLE))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("proj_iters", [1, 3])
def test_ransac_register_projective_matches_jax(jx, seed, proj_iters):
    """Three candidates (10-30% outliers) in one batched call against the
    JAX package's ransac_register one at a time, the JAX hypotheses
    injected, projective_iterations on."""
    jax, jnp, _, _, jreg = jx
    rng = np.random.default_rng(100 + seed)
    cands = []
    for b, frac in enumerate((0.1, 0.2, 0.3)):
        _, sx, _, dx, _ = _far_scene(10 * seed + b, outliers=frac)
        cands.append((sx, dx, rng.uniform(0, 60, len(sx)).astype(np.float32),
                      rng.uniform(size=len(sx)) < 0.95))
    idx = [_jax_indices(jx, seed + b, c[2], c[3]) for b, c in enumerate(cands)]
    refs = [jreg.ransac_register(jax.random.PRNGKey(seed + b), *(jnp.asarray(a) for a in c),
                                 refine_iterations=4, projective_iterations=proj_iters,
                                 cam_cx=CX, cam_cy=CY, **KW) for b, c in enumerate(cands)]
    src, dst, dist, valid = (torch.from_numpy(np.stack(a)) for a in zip(*cands))
    got = registration.ransac_register(
        None, src, dst, dist, valid, refine_iterations=4,
        sample_idx=torch.from_numpy(np.stack(idx).astype(np.int64)),
        projective_iterations=proj_iters, cam_cx=CX, cam_cy=CY, **KW)
    cov_s = registration.point_covariance_diag(src[..., 2], FX, FY, 0.01)
    cov_d = registration.point_covariance_diag(dst[..., 2], FX, FY, 0.01)
    m2 = registration.mahalanobis_sq(got.transform, src, dst, cov_s, cov_d)
    near = valid & ((m2 - GATE).abs() <= 1e-3 * GATE)
    for b, ref in enumerate(refs):
        np.testing.assert_allclose(got.transform[b].numpy(), np.asarray(ref.transform),
                                   rtol=0, atol=2e-4)
        diff = got.inliers[b].numpy() != np.asarray(ref.inliers)
        assert not (diff & ~near[b].numpy()).any()
        assert abs(int(got.n_inliers[b]) - int(ref.n_inliers)) <= int(near[b].sum())
        assert bool(got.success[b]) == bool(ref.success)


def test_projective_stage_keeps_t_when_it_would_lose_inliers():
    """The stage is kept only where its gate keeps no fewer inliers: with
    two valid matches (under 3, so no refit is kept either) the plain
    version returns the sweep's T whatever the stage computes, and with
    the stage off and on over a good candidate both return success."""
    su, sx, du, dx, T_true = _far_scene(8)
    valid = np.zeros(len(sx), bool)
    valid[:2] = True
    src, dst = torch.from_numpy(sx)[None], torch.from_numpy(dx)[None]
    cov_s = registration.point_covariance_diag(src[..., 2], FX, FY, 0.01)
    cov_d = registration.point_covariance_diag(dst[..., 2], FX, FY, 0.01)
    w = torch.ones(1, len(sx))
    T0 = torch.from_numpy(_perturbed(T_true, [0.3, 0.0, 0.0, 0.0, 0.2, 0.0]))[None]
    v = torch.from_numpy(valid)[None]
    pj = registration.Projective(3, FX, FY, CX, CY, 0.01)
    T, inl, n, _ = registration.ransac_refine_plain(src, dst, w, cov_s, cov_d, v, T0, v, 2,
                                                    GATE, pj)
    T_off, _, n_off, _ = registration.ransac_refine_plain(src, dst, w, cov_s, cov_d, v, T0, v,
                                                          2, GATE)
    assert int(n) >= int(n_off)
    if int(n) == int(n_off) == 0:
        assert torch.equal(T, T_off)


@pytest.mark.cuda
def test_cuda_projective_stage_matches_plain():
    """The refine kernel with projective_iterations 3 (and 1) against its
    plain version run in float64 on the card: T within 1e-5, masks equal
    off the gate, n_inliers within the near-gate count, rmse within 1e-5
    relative; one launch a call; the launch with the stage off unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import refine_against_plain, refine_problems

    dev = torch.device("cuda")
    for B, M, iters in ((8, 300, 3), (3, 37, 1), (2, 2000, 3)):
        args = [torch.from_numpy(a).to(dev)
                for a in refine_problems(np.random.default_rng(B * 100 + M), B, M)]
        before = registration.LAUNCHES
        pj = registration.Projective(iters, FX, FY, CX, CY, 0.01)
        r = refine_against_plain(args, projective=pj)
        assert registration.LAUNCHES == before + 1
        assert r["ok"], {k: v for k, v in r.items() if k not in ("got", "ref")}
        off = refine_against_plain(args)
        assert off["ok"]
