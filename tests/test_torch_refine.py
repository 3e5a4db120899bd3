"""Port parity: the RANSAC refinement (ops/registration.ransac_refine, the
masked Kabsch refits gated by the full-covariance Mahalanobis test, and the
final score) through ransac_register, against the JAX package's
ransac_register with the JAX hypothesis indices injected (torch cannot
reproduce jax.random's draws).

On the CPU the refinement runs its plain version: T within atol 1e-4 (as
tests/test_torch_matching_registration_emm.py holds ransac_register),
inlier masks, n_inliers and success exact. The port registers three
candidates in one batched call, the JAX package one at a time. The CUDA
kernel is held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.ops import registration as jreg  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import registration  # noqa: E402

torch.set_num_threads(1)
N_HYP, SAMPLE = 64, 4
KW = dict(cam_fx=525.0, cam_fy=525.0, n_hypotheses=N_HYP, sample_size=SAMPLE,
          max_mahal_sq=9.0, min_inliers=12, sigma_depth=0.01)


def _candidate(rng, M=120, outlier_frac=0.3, n_valid=None):
    """Matched points of one candidate: a small rigid motion, 3 mm noise,
    outliers moved up to 0.5 m; n_valid keeps only the first n valid."""
    src = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M),
                    rng.uniform(1.0, 4.0, M)], -1).astype(np.float32)
    xi = np.float32(rng.normal(0, [0.03, 0.03, 0.03, 0.02, 0.02, 0.02]))
    T = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    dst = src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.003, src.shape)
    out = rng.uniform(size=M) < outlier_frac
    dst[out] += rng.uniform(-0.5, 0.5, (int(out.sum()), 3))
    dist = rng.uniform(0, 60, M).astype(np.float32)
    valid = rng.uniform(size=M) < 0.95
    if n_valid is not None:
        valid[:] = False
        valid[:n_valid] = True
    return src, dst.astype(np.float32), dist, valid


def _jax_indices(seed, dist, valid):
    """The JAX function's own hypothesis draw for key PRNGKey(seed)."""
    M = len(dist)
    mv = jnp.asarray(valid)
    order = jnp.argsort(jnp.where(mv, jnp.asarray(dist), jnp.inf))
    rank = jnp.zeros((M,), jnp.float32).at[order].set(jnp.arange(M, dtype=jnp.float32))
    logits = jnp.where(mv, -rank * (4.0 / M), -jnp.inf)
    return np.asarray(jreg._gumbel_topk_sample(jax.random.PRNGKey(seed), logits, N_HYP, SAMPLE))


def _register_both(cands, seed, refine_iterations):
    """The port's batched ransac_register over the candidates and the JAX
    package's, one call a candidate, on the same hypothesis indices."""
    idx = [_jax_indices(seed + b, c[2], c[3]) for b, c in enumerate(cands)]
    refs = [jreg.ransac_register(jax.random.PRNGKey(seed + b), *(jnp.asarray(a) for a in c),
                                 refine_iterations=refine_iterations, **KW)
            for b, c in enumerate(cands)]
    src, dst, dist, valid = (torch.from_numpy(np.stack(a)) for a in zip(*cands))
    got = registration.ransac_register(
        None, src, dst, dist, valid, refine_iterations=refine_iterations,
        sample_idx=torch.from_numpy(np.stack(idx).astype(np.int64)), **KW)
    return got, refs


def _assert_equal(got, refs):
    for b, ref in enumerate(refs):
        np.testing.assert_allclose(got.transform[b].numpy(), np.asarray(ref.transform),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got.inliers[b].numpy(), np.asarray(ref.inliers))
        assert int(got.n_inliers[b]) == int(ref.n_inliers)
        assert bool(got.success[b]) == bool(ref.success)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("refine_iterations", [0, 1, 4, 6])
def test_ransac_register_refinement_matches_jax(refine_iterations, seed):
    rng = np.random.default_rng(seed)
    cands = [_candidate(rng, outlier_frac=f) for f in (0.2, 0.35, 0.5)]
    got, refs = _register_both(cands, 10 * seed, refine_iterations)
    _assert_equal(got, refs)
    if refine_iterations:  # the refits recover every candidate
        assert all(bool(r.success) for r in refs)
    assert got.rmse.shape == (3,) and bool(torch.isfinite(got.rmse).all())


def test_candidate_without_a_valid_match():
    """No valid match: no inlier before or after the refits, T stays the
    sweep's choice, rmse 0 and no success, in both packages."""
    rng = np.random.default_rng(5)
    cands = [_candidate(rng), _candidate(rng, n_valid=0)]
    got, refs = _register_both(cands, 3, 4)
    _assert_equal(got, refs)
    assert int(got.n_inliers[1]) == 0 and float(got.rmse[1]) == 0.0
    assert not bool(got.success[1]) and bool(got.success[0])


def test_refit_below_three_inliers_keeps_the_sweep():
    """Two valid matches: every refit gates fewer than 3 inliers, so no
    refit is kept and T is the hypothesis sweep's (refine_iterations 0)."""
    rng = np.random.default_rng(6)
    cands = [_candidate(rng, n_valid=2), _candidate(rng)]
    got, refs = _register_both(cands, 4, 4)
    _assert_equal(got, refs)
    swept, _ = _register_both(cands, 4, 0)
    assert torch.equal(got.transform[0], swept.transform[0])
    assert not torch.equal(got.transform[1], swept.transform[1])  # kept refits
    assert int(got.n_inliers[0]) <= 2


def test_refine_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(7)
    src, dst, _, valid = (torch.from_numpy(a)[None] for a in _candidate(rng, M=16))
    w = torch.ones(1, 16)
    cov = torch.full((1, 16, 3), 1e-4)
    args = (src, dst, w, cov, cov, valid, torch.eye(4)[None], valid, 4, 9.0)
    with pytest.raises(ValueError, match="CUDA"):
        registration.ransac_refine_cuda(*args)
    before = registration.LAUNCHES
    T, inl, n, rmse = registration.ransac_refine(*args)  # CPU: the plain version
    assert registration.LAUNCHES == before
    ref = registration.ransac_refine_plain(*args)
    assert torch.equal(T, ref[0]) and torch.equal(inl, ref[1]) and torch.equal(n, ref[2])
    assert n.dtype == torch.int32 and inl.dtype == torch.bool and rmse.shape == (1,)
