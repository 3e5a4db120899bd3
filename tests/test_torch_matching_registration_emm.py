"""Port parity: descriptor matching, RANSAC registration and the EMM.

* match_descriptors: indices, distances and validity exact.
* ransac_register: the JAX hypothesis indices are injected (torch cannot
  reproduce jax.random's draws); transform within atol 1e-4, inlier mask
  exact.
* emm_pool_maps bit-exact; observation_likelihood counts exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.core.camera import backproject_grid  # noqa: E402
from rgbdslam_v2_tpu.ops import emm as jemm, matching as jmatch, registration as jreg  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import emm, matching, registration  # noqa: E402

torch.set_num_threads(1)


def _descriptors(rng, k, d=256):
    return np.where(rng.uniform(size=(k, d)) < 0.5, 1, -1).astype(np.int8)


def test_match_descriptors_exact():
    rng = np.random.default_rng(0)
    K, B = 200, 3
    a = _descriptors(rng, K)
    bs, vbs = [], []
    for _ in range(B):
        b = _descriptors(rng, K)
        src = rng.choice(K, 120, replace=False)
        dst = rng.choice(K, 120, replace=False)
        noisy = a[src].copy()
        flip = rng.uniform(size=noisy.shape) < rng.uniform(0.02, 0.3, (120, 1))
        noisy[flip] *= -1
        b[dst] = noisy
        b[dst[:5]] = b[dst[5:10]]  # duplicate train rows: dedup ties
        bs.append(b)
        vbs.append(rng.uniform(size=K) < 0.9)
    va = rng.uniform(size=K) < 0.9
    got = matching.match_descriptors(torch.from_numpy(a), torch.from_numpy(va),
                                     torch.from_numpy(np.stack(bs)),
                                     torch.from_numpy(np.stack(vbs)), 100, 0.95)
    assert int(got.valid.sum()) > 100
    for i in range(B):
        ref = jmatch.match_descriptors(jnp.asarray(a), jnp.asarray(va), jnp.asarray(bs[i]),
                                       jnp.asarray(vbs[i]), 100, 0.95)
        for name in ("src_idx", "dst_idx", "dist", "valid"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(ref, name)))


def _matched_points(seed, M=120, outlier_frac=0.3):
    rng = np.random.default_rng(seed)
    src = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M),
                    rng.uniform(1.0, 4.0, M)], -1).astype(np.float32)
    T = np.asarray(jse3.exp_se3(jnp.asarray(np.float32([0.05, -0.02, 0.03, 0.02, -0.04, 0.01]))))
    dst = src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.003, src.shape)
    out = rng.uniform(size=M) < outlier_frac
    dst[out] += rng.uniform(-0.5, 0.5, (int(out.sum()), 3))
    dist = rng.uniform(0, 60, M).astype(np.float32)
    valid = rng.uniform(size=M) < 0.95
    return src, dst.astype(np.float32), dist, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_register_with_injected_hypotheses(seed):
    src, dst, dist, valid = _matched_points(seed)
    M, n_hyp, S = len(src), 64, 4
    key = jax.random.PRNGKey(seed)
    # the JAX function's own sampling, reproduced for injection
    mv = jnp.asarray(valid)
    order = jnp.argsort(jnp.where(mv, jnp.asarray(dist), jnp.inf))
    rank = jnp.zeros((M,), jnp.float32).at[order].set(jnp.arange(M, dtype=jnp.float32))
    logits = jnp.where(mv, -rank * (4.0 / M), -jnp.inf)
    idx = np.asarray(jreg._gumbel_topk_sample(key, logits, n_hyp, S))
    kw = dict(cam_fx=525.0, cam_fy=525.0, n_hypotheses=n_hyp, sample_size=S,
              max_mahal_sq=9.0, refine_iterations=6, min_inliers=12, sigma_depth=0.01)
    ref = jreg.ransac_register(key, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(dist),
                               mv, **kw)
    got = registration.ransac_register(
        None, torch.from_numpy(src)[None], torch.from_numpy(dst)[None],
        torch.from_numpy(dist)[None], torch.from_numpy(valid)[None],
        sample_idx=torch.from_numpy(idx.astype(np.int64))[None], **kw)
    assert bool(got.success[0]) and bool(ref.success)
    np.testing.assert_allclose(got.transform[0].numpy(), np.asarray(ref.transform), atol=1e-4)
    np.testing.assert_array_equal(got.inliers[0].numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers[0]) == int(ref.n_inliers)


def test_gumbel_sampling_draws_distinct_valid_indices():
    g = torch.Generator().manual_seed(0)
    logits = torch.full((2, 50), float("-inf"))
    logits[0, :30] = 0.0
    logits[1, :3] = 0.0  # fewer finite entries than the sample size
    idx = registration.gumbel_topk_sample(g, logits, 16, 4)
    assert idx.shape == (2, 16, 4)
    assert all(len(set(row.tolist())) == 4 for row in idx.reshape(-1, 4))
    assert bool((idx[0] < 30).all())
    assert bool((idx[1, :, :3] < 3).all())


def _depth(rng, h=60, w=80):
    d = rng.uniform(0.5, 6.0, (h, w)).astype(np.float32)
    d[rng.uniform(size=(h, w)) < 0.15] = 0.0
    return d


def test_emm_pool_maps_bit_exact():
    d = _depth(np.random.default_rng(0))
    ref = np.array(jemm.emm_pool_maps(jnp.asarray(d)))
    got = emm.emm_pool_maps(torch.from_numpy(d)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)
    lo_r, hi_r = jemm.emm_unpack(jnp.asarray(ref))
    lo_t, hi_t = emm.emm_unpack(torch.from_numpy(ref.view(np.int32)))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_r))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_r))


def test_observation_likelihood_counts_exact():
    rng = np.random.default_rng(1)
    cam = (65.0, 65.0, 40.0, 30.0, 80, 60)
    new_d, old_d = _depth(rng), _depth(rng)
    old_d[20:40, 30:50] = 1.2  # a near surface: occlusions
    pts = np.asarray(backproject_grid(jnp.asarray(new_d), JIntrinsics(*cam)))
    Ts = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, s, 6).astype(np.float32))))
                   for s in (0.0, 0.02, 0.1)])
    got = emm.observation_likelihood(
        torch.from_numpy(Ts), torch.from_numpy(pts).reshape(1, -1, 3),
        torch.from_numpy(new_d > 0).reshape(1, -1), Intrinsics(*cam),
        emm.emm_pool_maps(torch.from_numpy(old_d)).reshape(1, -1))
    assert int(got.inliers.sum()) > 100
    for b in range(len(Ts)):
        ref = jemm.observation_likelihood(jnp.asarray(Ts[b]), jnp.asarray(pts),
                                          jnp.asarray(new_d > 0), jnp.asarray(old_d),
                                          JIntrinsics(*cam), 1)
        for name in ("inliers", "outliers", "occluded", "all_projected"):
            assert int(getattr(got, name)[b]) == int(getattr(ref, name)), name
        np.testing.assert_allclose(float(got.quality[b]), float(ref.quality), rtol=1e-6)
