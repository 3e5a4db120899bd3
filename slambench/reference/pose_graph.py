"""The pose graph's optimum, written plainly.

The cost of a graph (the objective of RGBDSLAMv2's g2o optimization as the
configurations set it up): over the active edges, the Huber-robust chi2
of r = log(Z^-1 X_i^-1 X_j) under the edge's information Omega,

    rho(c) = c where c <= delta^2, else 2 delta sqrt(c) - delta^2,  c = r' Omega r,

with the fixed nodes held where they are. :func:`solve` minimises it by
Gauss-Newton steps on SE(3) (right perturbations, reweighted for the
Huber kernel, halved while a step does not lower the cost), each solved
exactly as one sparse linear system, in float64 until a step lowers the
cost by less than 1e-12 of it. `rnd` rounds the poses, residuals,
Jacobians and the normal equations: the identity for the reference,
bfloat16 for the control.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from . import se3
from .precision import exact


def _chi2(poses, g):
    Xi, Xj = poses[g["i"]], poses[g["j"]]
    B = se3.inv(Xi) @ Xj
    r = se3.log(se3.inv(g["Z"]) @ B)
    return r, B, np.einsum("ei,eij,ej->e", r, g["info"], r)


def cost(poses: np.ndarray, g: dict, delta: float) -> float:
    """Huber cost of graph g (edges i, j, Z, info of its active edges) at poses."""
    _, _, c = _chi2(poses, g)
    return float(np.where(c <= delta * delta, c, 2.0 * delta * np.sqrt(c) - delta * delta).sum())


def active_edges(graph: dict) -> dict:
    a = graph["edge_active"].astype(bool)
    return {"i": graph["edge_i"][a].astype(np.int64), "j": graph["edge_j"][a].astype(np.int64),
            "Z": graph["edge_meas"][a].astype(np.float64),
            "info": graph["edge_info"][a].astype(np.float64)}


def solve(poses0: np.ndarray, g: dict, fixed: np.ndarray, delta: float, rnd=exact,
          max_iterations: int = 50, tol: float = 1e-12) -> np.ndarray:
    """The poses (n, 4, 4) that minimise the Huber cost of g from poses0,
    the nodes where `fixed` held."""
    n = len(poses0)
    X = rnd(poses0.astype(np.float64))
    free = ~fixed
    col = -np.ones(n, np.int64)
    col[free] = np.arange(free.sum())
    m = int(free.sum())
    if m == 0 or len(g["i"]) == 0:
        return X
    f = cost(X, g, delta)
    for _ in range(max_iterations):
        r, B, c = _chi2(X, g)
        r = rnd(r)
        w = np.where(c <= delta * delta, 1.0, delta / np.sqrt(np.maximum(c, 1e-300)))
        W = g["info"] * w[:, None, None]
        Ji = rnd(-se3.adjoint(se3.inv(B)))
        blocks = {"ii": np.einsum("eki,ekl,elj->eij", Ji, W, Ji), "jj": W,
                  "ij": np.einsum("eki,ekl->eil", Ji, W)}
        bi = np.einsum("eki,ek->ei", Ji, np.einsum("eij,ej->ei", W, r))
        bj = np.einsum("eij,ej->ei", W, r)
        rows, cols, vals = [], [], []
        for (a, b_), key, tr in (((g["i"], g["i"]), "ii", False), ((g["j"], g["j"]), "jj", False),
                                 ((g["i"], g["j"]), "ij", False), ((g["j"], g["i"]), "ij", True)):
            ok = free[a] & free[b_]
            blk = blocks[key][ok]
            if tr:
                blk = np.swapaxes(blk, -1, -2)
            ra = col[a[ok]][:, None, None] * 6 + np.arange(6)[None, :, None]
            cb = col[b_[ok]][:, None, None] * 6 + np.arange(6)[None, None, :]
            rows.append(np.broadcast_to(ra, blk.shape).ravel())
            cols.append(np.broadcast_to(cb, blk.shape).ravel())
            vals.append(blk.ravel())
        H = sp.csc_matrix((rnd(np.concatenate(vals)), (np.concatenate(rows),
                                                       np.concatenate(cols))), shape=(6 * m,) * 2)
        b = np.zeros((n, 6))
        np.add.at(b, g["i"], bi)
        np.add.at(b, g["j"], bj)
        rhs = rnd(-b[free].ravel())
        dx = np.zeros((n, 6))
        dx[free] = spla.spsolve(H + sp.identity(6 * m, format="csc") * 1e-12, rhs).reshape(m, 6)
        step, improved = 1.0, False
        for _ in range(12):
            Xn = rnd(X @ se3.exp(step * dx))
            fn = cost(Xn, g, delta)
            if fn < f:
                improved = True
                break
            step *= 0.5
        if not improved:
            break
        done = (f - fn) < tol * f
        X, f = Xn, fn
        if done:
            break
    return X


# a graph without a loop (a tree) has the optimum cost 0: below this chi2
# an active edge the excess is taken over this floor instead
CHI2_FLOOR_PER_EDGE = 1e-6


def excess(prog_poses: np.ndarray, graph: dict, fixed: np.ndarray, delta: float,
           rnd=exact) -> tuple:
    """(relative excess of the judged poses' Huber cost over the float64
    optimum's, the optimum). The optimum is sought from the program's
    poses; with `rnd` the judged poses are the reference's own solve in
    that precision (the control) instead of the program's."""
    g = active_edges(graph)
    best = solve(prog_poses, g, fixed, delta)
    judged = prog_poses if rnd is exact else solve(prog_poses, g, fixed, delta, rnd=rnd)
    c_best = cost(best, g, delta)
    floor = max(c_best, CHI2_FLOOR_PER_EDGE * len(g["i"]), 1e-30)
    return (cost(judged, g, delta) - c_best) / floor, best
