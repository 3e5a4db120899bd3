"""Pairwise registration of two nodes from their keypoints, written plainly.

The semantics of one visual edge of the keep-all graph (RGBDSLAMv2's
``Node::getRelativeTransformationTo``, as the configurations set it up):

1. matching: each keypoint of the new node against the candidate's, nearest
   and second-nearest by Hamming distance (binary descriptors) or squared
   L2 (float descriptors), kept when nearest < ratio x second, one match a
   candidate keypoint (its closest query, the first on ties), the
   `max_matches` closest (stable on ties);
2. RANSAC: hypotheses fitted to `sample_size` matches drawn without
   replacement, more often among the closer matches, plus the identity;
   inliers under an isotropic Mahalanobis gate; the best by inlier count
   less a fraction for their mean error;
3. refinement: `refine_iterations` weighted least-squares refits (weights
   1 / (z_src z_dst)) on the inliers, each re-gated with the full
   covariance of both points (sigma_depth z^2 along the ray, (z / f)^2 / 9
   across it; the squared Mahalanobis distance as the system defines it,
   with the covariance's determinant floored at 1e-18), kept where at
   least 3 inliers remain.

The result maps the new node's points into the candidate's frame: the
edge measurement cand_T_new, which is X_cand^-1 X_new.

Everything is float64 NumPy. `rnd` rounds the points, the covariances and
each fitted transform: the identity for the reference, bfloat16 for the
control.
"""
from __future__ import annotations

import numpy as np

from . import se3
from .precision import exact

BIG = 1e9


def distances(desc_q: np.ndarray, desc_t: np.ndarray, binary: bool) -> np.ndarray:
    a = desc_q.astype(np.float64)
    b = desc_t.astype(np.float64)
    dot = a @ b.T
    if binary:  # +/-1 entries: Hamming = (D - a.b) / 2
        return (a.shape[-1] - dot) * 0.5
    return np.maximum((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * dot, 0.0)


def match(desc_q, valid_q, desc_t, valid_t, max_matches: int, ratio: float, binary: bool):
    """(query index, train index, distance) of the kept matches, closest first."""
    Ka, Kb = len(desc_q), len(desc_t)
    d = np.where(valid_q[:, None] & valid_t[None, :], distances(desc_q, desc_t, binary), BIG)
    nn = np.argmin(d, axis=1)
    d1 = d[np.arange(Ka), nn]
    d2 = d.copy()
    d2[np.arange(Ka), nn] = BIG
    d2 = d2.min(axis=1)
    ok = (d1 < ratio * d2) & (d1 < BIG * 0.5) & valid_q
    keep = np.zeros(Ka, bool)
    best = {}
    for q in np.nonzero(ok)[0]:  # one match a train keypoint: its closest, first on ties
        t = nn[q]
        if t not in best or d1[q] < d1[best[t]]:
            best[t] = q
    keep[list(best.values())] = True
    q_idx = np.nonzero(keep)[0]
    order = np.argsort(d1[q_idx], kind="stable")[: min(max_matches, Ka)]
    q_idx = q_idx[order]
    return q_idx, nn[q_idx], d1[q_idx]


def point_cov(z: np.ndarray, fx: float, fy: float, sigma_depth: float) -> np.ndarray:
    """Diagonal (..., 3) covariance of a back-projected point at depth z."""
    sd = sigma_depth * z * z
    return np.stack([(z / fx) ** 2 / 9.0 + 1e-12, (z / fy) ** 2 / 9.0 + 1e-12, sd * sd + 1e-9],
                    -1)


def kabsch(src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted least-squares dst ~ R src + t over the last two axes:
    (..., M, 3) points, (..., M) weights -> (..., 4, 4)."""
    ws = np.maximum(w.sum(-1), 1e-12)[..., None]
    mu_s = (w[..., None] * src).sum(-2) / ws
    mu_d = (w[..., None] * dst).sum(-2) / ws
    H = np.einsum("...m,...mi,...mj->...ij", w, src - mu_s[..., None, :], dst - mu_d[..., None, :])
    U, _, Vt = np.linalg.svd(H)
    V = np.swapaxes(Vt, -1, -2)
    Ut = np.swapaxes(U, -1, -2)
    D = np.zeros(H.shape)
    D[..., 0, 0] = D[..., 1, 1] = 1.0
    D[..., 2, 2] = np.linalg.det(V @ Ut)
    R = V @ D @ Ut
    out = np.zeros((*H.shape[:-2], 4, 4))
    out[..., :3, :3] = R
    out[..., :3, 3] = mu_d - (R @ mu_s[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


# the system's Mahalanobis solve divides the adjugate by det(Sigma) with
# |det| < 1e-18 taken as 1e-18 (the JAX package's ops/registration
# _sym3_solve, which the port follows): below ~0.55 m both points' Sigma
# has a smaller determinant, and the distance reads that much smaller
DET_FLOOR = 1e-18


def mahalanobis_sq(T, src, dst, src_cov, dst_cov) -> np.ndarray:
    R = T[:3, :3]
    diff = se3.apply(T, src) - dst
    Sigma = np.einsum("ij,mj,kj->mik", R, src_cov, R) + np.einsum("mi,ij->mij", dst_cov,
                                                                   np.eye(3))
    x = np.linalg.solve(Sigma, diff[..., None])[..., 0]
    det = np.linalg.det(Sigma)
    return (diff * x).sum(-1) * np.where(np.abs(det) < DET_FLOOR, det / DET_FLOOR, 1.0)


def register(src, dst, dist, rng: np.random.Generator, *, fx: float, fy: float,
             sigma_depth: float, n_hypotheses: int, sample_size: int, max_mahal_sq: float,
             refine_iterations: int, rnd=exact):
    """RANSAC and refinement on matched points (M, 3) src (new) and dst
    (candidate) with descriptor distances (M,): (T dst_T_src, inlier mask)."""
    src, dst = rnd(src), rnd(dst)
    M = len(src)
    if M < sample_size:
        return np.eye(4), np.zeros(M, bool)
    w = 1.0 / (np.maximum(src[:, 2], 1e-3) * np.maximum(dst[:, 2], 1e-3))
    src_cov = rnd(point_cov(src[:, 2], fx, fy, sigma_depth))
    dst_cov = rnd(point_cov(dst[:, 2], fx, fy, sigma_depth))
    # draws without replacement, more often among the closer matches
    rank = np.empty(M)
    rank[np.argsort(dist, kind="stable")] = np.arange(M)
    keys = rng.gumbel(size=(n_hypotheses, M)) - rank * (4.0 / M)
    idx = np.argsort(-keys, axis=1)[:, :sample_size]
    T_h = rnd(kabsch(src[idx], dst[idx], w[idx]))
    T_h = np.concatenate([T_h, np.eye(4)[None]], 0)
    iso = (src_cov + dst_cov).mean(-1)
    diff = np.einsum("hij,mj->hmi", T_h[:, :3, :3], src) + T_h[:, None, :3, 3] - dst[None]
    m2 = rnd((diff * diff).sum(-1) / iso[None])
    inl = m2 < max_mahal_sq
    n_h = inl.sum(-1)
    err = np.where(inl, m2, 0.0).sum(-1) / np.maximum(n_h, 1)
    best = int(np.argmax(n_h - err / (err + 1.0)))
    return refine(T_h[best], inl[best], src, dst, w, src_cov, dst_cov, max_mahal_sq,
                  refine_iterations, rnd)


def refine(T, inliers, src, dst, w, src_cov, dst_cov, max_mahal_sq: float, iterations: int,
           rnd=exact):
    """`iterations` weighted refits on the inliers, each re-gated with the
    full covariance and kept where at least 3 inliers remain. Returns (T,
    the final gate's inliers)."""
    for _ in range(iterations):
        T2 = rnd(kabsch(src, dst, np.where(inliers, w, 0.0)))
        inl2 = rnd(mahalanobis_sq(T2, src, dst, src_cov, dst_cov)) < max_mahal_sq
        if inl2.sum() >= 3:
            T, inliers = T2, inl2
    inliers = rnd(mahalanobis_sq(T, src, dst, src_cov, dst_cov)) < max_mahal_sq
    return T, inliers


def matched_points(new: dict, cand: dict, cfg: dict):
    """The matches of node `new` against node `cand` (dicts of the node
    store's xyz (K, 3), desc (K, D), valid (K,)): (src (M, 3) in the new
    node, dst (M, 3) in the candidate, distances (M,)), float64."""
    q, t, d = match(new["desc"], new["valid"], cand["desc"], cand["valid"],
                    cfg["max_matches"], cfg["nn_distance_ratio"], cfg["binary"])
    return new["xyz"][q].astype(np.float64), cand["xyz"][t].astype(np.float64), d


def register_nodes(new: dict, cand: dict, cfg: dict, rng: np.random.Generator, rnd=exact):
    """Register node `new` against node `cand` under the configuration's
    matching and RANSAC settings: cand_T_new (4, 4)."""
    src, dst, d = matched_points(new, cand, cfg)
    T, _ = register(src, dst, d, rng, fx=cfg["fx"], fy=cfg["fy"],
                    sigma_depth=cfg["sigma_depth"], n_hypotheses=cfg["ransac_iterations"],
                    sample_size=cfg["sample_candidates"],
                    max_mahal_sq=cfg["max_dist_for_inliers"] ** 2,
                    refine_iterations=cfg["refine_iterations"], rnd=rnd)
    return T


def edge_information(T: np.ndarray, src, dst, cfg: dict, rnd=exact) -> float:
    """The information an accepted edge carries (RGBDSLAMv2's inlier count
    over the squared inlier error, as the configurations use it): the
    matches gated at T with the full covariance, n inliers with RMS
    Mahalanobis distance rmse, n / max(rmse^2, 1e-4)."""
    src, dst = rnd(src), rnd(dst)
    src_cov = rnd(point_cov(src[:, 2], cfg["fx"], cfg["fy"], cfg["sigma_depth"]))
    dst_cov = rnd(point_cov(dst[:, 2], cfg["fx"], cfg["fy"], cfg["sigma_depth"]))
    m2 = rnd(mahalanobis_sq(rnd(T), src, dst, src_cov, dst_cov))
    inl = m2 < cfg["max_dist_for_inliers"] ** 2
    n = int(inl.sum())
    rmse2 = float(rnd(np.where(inl, m2, 0.0).sum() / max(n, 1)))
    return n / max(rmse2, 1e-4)


def refit_gap(T: np.ndarray, src, dst, cfg: dict) -> float:
    """How far one more refinement moves an edge's transform: the matches
    gated at T with the full covariance, their weighted least-squares fit
    (weights 1 / (z_src z_dst)), and the RMS distance (m) by which the fit
    and T move the inliers apart. A transform that the configured
    refinement produced is the fit of the inliers it gates, up to the
    refits the configuration leaves undone; a transform moved after its fit
    is not. Infinite where fewer than 3 inliers remain."""
    src_cov = point_cov(src[:, 2], cfg["fx"], cfg["fy"], cfg["sigma_depth"])
    dst_cov = point_cov(dst[:, 2], cfg["fx"], cfg["fy"], cfg["sigma_depth"])
    inl = mahalanobis_sq(T, src, dst, src_cov, dst_cov) < cfg["max_dist_for_inliers"] ** 2
    if inl.sum() < 3:
        return float("inf")
    w = 1.0 / (np.maximum(src[inl, 2], 1e-3) * np.maximum(dst[inl, 2], 1e-3))
    return transform_gap(T, kabsch(src[inl], dst[inl], w), src[inl])


def transform_gap(A: np.ndarray, B: np.ndarray, pts: np.ndarray) -> float:
    """RMS distance (m) between A p and B p over the points (the inliers of
    an edge): how far two estimates of one edge move the points it rests
    on; infinite where fewer than 3 points support the edge."""
    if len(pts) < 3:
        return float("inf")
    d = se3.apply(A, pts) - se3.apply(B, pts)
    return float(np.sqrt((d * d).sum(-1).mean()))
