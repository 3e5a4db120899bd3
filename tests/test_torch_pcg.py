"""Port parity for the PCG pose-graph solver: `_pcg`, `_chol_solve_6`,
`lm_iteration(solver="pcg")` and `optimize(solver="pcg")`, JAX package
against the port, on a random 40-node / 160-edge graph made with numpy
(node 0 and two more held fixed, a few outlier edges for the Huber kernel).

Tolerances: poses atol 1e-4 and chi2 rtol 1e-3 (float32, other summation
order in the scatter-adds and dot products); `_pcg` on a fixed SPD system
and the 6x6 block solves rtol 1e-4. "auto" picks the solver by capacity in
both packages: PCG above 1024 nodes, however few are active.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.optim import pose_graph as jpg  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.optim import pose_graph as tpg  # noqa: E402

torch.set_num_threads(1)
N, E = 40, 160
FIXED = (0, 13, 27)


def _exp(xi):
    return np.asarray(jse3.exp_se3(jnp.asarray(np.asarray(xi, np.float32))))


def _graph(n_cap=N, seed=0):
    """A noisy odometry chain plus random loop edges, 40 active nodes in a
    graph of capacity n_cap."""
    rng = np.random.default_rng(seed)
    xi = np.cumsum(rng.normal(0, 0.1, (N, 6)), 0)
    xi[0] = 0
    gt = _exp(xi)
    pairs = [(i, i + 1) for i in range(N - 1)]
    while len(pairs) < E:
        i, j = sorted(rng.choice(N, 2, replace=False))
        pairs.append((int(i), int(j)))
    ei = np.array([p[0] for p in pairs], np.int32)
    ej = np.array([p[1] for p in pairs], np.int32)
    meas = np.linalg.inv(gt[ei]) @ gt[ej] @ _exp(rng.normal(0, 0.01, (E, 6)))
    meas[-4:] = _exp(rng.normal(0, 0.5, (4, 6)))  # outliers
    init = gt @ _exp(rng.normal(0, 0.05, (N, 6)))
    init[list(FIXED)] = gt[list(FIXED)]
    info = np.eye(6, dtype=np.float32) * rng.uniform(10, 1000, (E, 1, 1))
    g = jpg.make_graph_state(n_cap, E)
    fixed = np.zeros(n_cap, bool)
    fixed[list(FIXED)] = True
    return g._replace(
        poses=g.poses.at[:N].set(init.astype(np.float32)),
        node_active=g.node_active.at[:N].set(True), node_fixed=jnp.asarray(fixed),
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        edge_meas=jnp.asarray(meas.astype(np.float32)),
        edge_info=jnp.asarray(info.astype(np.float32)), edge_active=g.edge_active.at[:].set(True),
    )


def _port(g):
    return interop.graph_from_numpy({k: np.asarray(v) for k, v in g._asdict().items()})


def test_lm_iteration_pcg_matches_jax():
    g = _graph()
    lam = 1e-4
    jg, jlam, jc0, jc1 = jpg.lm_iteration(g, jnp.float32(lam), 1.0, pcg_iters=24, solver="pcg")
    poses, tlam, tc0, tc1 = tpg.lm_iteration(_port(g), torch.tensor(lam), 1.0, pcg_iters=24,
                                             solver="pcg")
    np.testing.assert_allclose(poses.numpy(), np.asarray(jg.poses), atol=1e-4)
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-3)
    np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-3)
    assert float(tlam) == pytest.approx(float(jlam))
    assert float(tc1) < float(tc0)  # the step was accepted


def test_optimize_pcg_matches_jax():
    g = _graph()
    jg, jchi2, jit = jpg.optimize(g, iterations=10, pcg_iters=24, solver="pcg")
    tg = _port(g)
    chi2, it = tpg.optimize(tg, iterations=10, pcg_iters=24, solver="pcg")
    assert it == int(jit)
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(jg.poses), atol=1e-4)
    np.testing.assert_allclose(float(chi2), float(jchi2), rtol=1e-3)
    for k in FIXED:  # fixed nodes do not move
        np.testing.assert_array_equal(tg.poses[k].numpy(), np.asarray(g.poses[k]))


def _spd_system(seed=3, n=24):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(6 * n, 6 * n))
    H = (A @ A.T / (6 * n) + np.eye(6 * n)).astype(np.float32)
    b = rng.normal(size=(n, 6)).astype(np.float32)
    blocks = np.stack([H[6 * i : 6 * i + 6, 6 * i : 6 * i + 6] for i in range(n)])
    return H, b, blocks


def test_pcg_on_fixed_spd_system_matches_jax():
    H, b, blocks = _spd_system()
    n = b.shape[0]
    jx = jpg._pcg(lambda v: (jnp.asarray(H) @ v.reshape(-1)).reshape(n, 6),
                  lambda v: jpg._chol_solve_6(jnp.asarray(blocks), v), jnp.asarray(b), 24)
    Ht, Bt = torch.from_numpy(H), torch.from_numpy(blocks)
    tx = tpg._pcg(lambda v: (Ht @ v.reshape(-1)).reshape(n, 6),
                  lambda v: tpg._chol_solve_6(Bt, v), torch.from_numpy(b), 24)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-6)
    resid = H.astype(np.float64) @ tx.numpy().reshape(-1) - b.reshape(-1)
    assert np.linalg.norm(resid) < 0.05 * np.linalg.norm(b)  # 24 iterations solve it


def test_chol_solve_6_matches_jax():
    _, b, blocks = _spd_system(seed=4)
    ref = np.asarray(jpg._chol_solve_6(jnp.asarray(blocks), jnp.asarray(b)))
    got = tpg._chol_solve_6(torch.from_numpy(blocks), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_pcg_freezes_a_converged_state(seed):
    """Once the residual meets the tolerance the CG state is frozen by
    masking (the host never reads the flag): more iterations give the
    bitwise same result."""
    H, b, blocks = _spd_system(seed=seed, n=8)
    Ht, Bt = torch.from_numpy(H), torch.from_numpy(blocks)

    def run(iters):
        return tpg._pcg(lambda v: (Ht @ v.reshape(-1)).reshape(8, 6),
                        lambda v: tpg._chol_solve_6(Bt, v), torch.from_numpy(b), iters)

    assert torch.equal(run(80), run(200))
    assert not torch.equal(run(2), run(80))


@pytest.mark.parametrize("n_cap, solver", [(1024, "dense"), (1100, "pcg")])
def test_auto_picks_the_solver_by_capacity(monkeypatch, n_cap, solver):
    """40 active nodes in a graph of capacity n_cap: both packages choose by
    the capacity, and the port's pick over the active prefix gives the JAX
    result over the whole capacity."""
    g = _graph(n_cap)
    seen = {}
    real = jpg._optimize_jit

    def spy(*args):
        seen["jax"] = args[-1]
        return real(*args)

    monkeypatch.setattr(jpg, "_optimize_jit", spy)
    jg, jchi2, _ = jpg.optimize(g, iterations=3, pcg_iters=24, solver="auto")
    tg = _port(g)
    real_lm = tpg.lm_iteration

    def spy_lm(*args):
        seen["port"] = args[4]
        return real_lm(*args)

    monkeypatch.setattr(tpg, "lm_iteration", spy_lm)
    chi2, _ = tpg.optimize(tg, iterations=3, pcg_iters=24, solver="auto", n_nodes=N,
                           n_edges=E)
    assert seen == {"jax": solver, "port": solver}
    assert tpg.resolve_solver("auto", n_cap) == solver
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(jg.poses), atol=1e-4)
    np.testing.assert_allclose(float(chi2), float(jchi2), rtol=1e-3)


def test_graph_state_is_unchanged_by_the_prefix_view():
    """optimize over the prefix writes the poses in place and leaves the
    inactive tail as it was."""
    g = _graph(64)
    tg = _port(g)
    tail = tg.poses[N:].clone()
    tpg.optimize(tg, iterations=2, pcg_iters=24, solver="pcg", n_nodes=N, n_edges=E)
    assert torch.equal(tg.poses[N:], tail)
    assert not torch.equal(tg.poses[:N], _port(g).poses[:N])
    assert dataclasses.is_dataclass(tg)
