"""Port parity: pose-graph optimization on a graph built by the JAX package and
carried into the port with `interop`, plus interop round trips.

edge_chi2 agrees to rtol 1e-5; poses after optimize (dense solver) to atol
1e-4 (float32 Cholesky of the same normal equations, other summation
order). The port solves over the active prefix of a larger capacity: the
inactive tail is fixed with a unit diagonal in the reference, so the
solution is the same.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core import se3 as jse3  # noqa: E402
from rgbdslam_v2_tpu.graph.node_store import NodeStore as JNodeStore  # noqa: E402
from rgbdslam_v2_tpu.models.types import Keypoints as JKeypoints  # noqa: E402
from rgbdslam_v2_tpu.optim import pose_graph as jpg  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.optim import pose_graph as tpg  # noqa: E402

torch.set_num_threads(1)
N, N_CAP, E_CAP = 32, 40, 160


def _jax_graph(seed=0):
    """32 active nodes on a noisy odometry chain + loop edges."""
    rng = np.random.default_rng(seed)
    xi = np.cumsum(rng.normal(0, 0.1, (N, 6)), 0).astype(np.float32)
    xi[0] = 0
    gt = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    pairs = [(i, i + 1) for i in range(N - 1)]
    pairs += [tuple(sorted(rng.choice(N, 2, replace=False))) for _ in range(40)]
    ei = np.array([p[0] for p in pairs], np.int32)
    ej = np.array([p[1] for p in pairs], np.int32)
    rel = np.asarray(jse3.inv(jnp.asarray(gt[ei]))) @ gt[ej]
    noise = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.01, (len(pairs), 6))
                                                .astype(np.float32))))
    meas = rel @ noise
    meas[-3:] = np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.5, (3, 6))
                                                    .astype(np.float32))))  # outliers
    init = gt @ np.asarray(jse3.exp_se3(jnp.asarray(rng.normal(0, 0.05, (N, 6))
                                                    .astype(np.float32))))
    init[0] = gt[0]
    g = jpg.make_graph_state(N_CAP, E_CAP)
    E = len(pairs)
    info = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1)) * rng.uniform(10, 1000, (E, 1, 1))
    return g._replace(
        poses=g.poses.at[:N].set(init),
        node_active=g.node_active.at[:N].set(True),
        node_fixed=g.node_fixed.at[0].set(True),
        edge_i=g.edge_i.at[:E].set(ei), edge_j=g.edge_j.at[:E].set(ej),
        edge_meas=g.edge_meas.at[:E].set(meas),
        edge_info=g.edge_info.at[:E].set(info.astype(np.float32)),
        edge_active=g.edge_active.at[:E].set(True),
    ), E


def _port_graph(g):
    return interop.graph_from_numpy({k: np.asarray(v) for k, v in g._asdict().items()})


def test_edge_chi2_matches_jax():
    g, _ = _jax_graph()
    ref = np.asarray(jpg.edge_chi2(g))
    got = tpg.edge_chi2(_port_graph(g)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prefix", [False, True])
def test_optimize_dense_matches_jax(prefix):
    g, E = _jax_graph()
    g_ref, chi2_ref, _ = jpg.optimize(g, iterations=10, solver="dense")
    tg = _port_graph(g)
    kw = dict(n_nodes=N, n_edges=E) if prefix else {}
    chi2, iters = tpg.optimize(tg, iterations=10, **kw)
    assert 1 <= iters <= 10
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(g_ref.poses), atol=1e-4)
    np.testing.assert_allclose(float(chi2), float(chi2_ref), rtol=1e-3)
    assert float(chi2) < float(jnp.sum(jpg.edge_chi2(g)))


def _roundtrip(jax_state, to_port):
    src = {k: np.asarray(v) for k, v in jax_state._asdict().items()}
    back = interop.to_numpy(to_port(src))
    for k, v in back.items():
        assert v.dtype == src[k].dtype, k
        np.testing.assert_array_equal(v, src[k], err_msg=k)
    return back


def test_interop_roundtrip_bit_exact():
    """JAX state -> numpy -> port -> numpy equals the original bit for bit
    (the JAX store's emm_zs plane has no port counterpart)."""
    g, _ = _jax_graph(1)
    _roundtrip(g, interop.graph_from_numpy)
    rng = np.random.default_rng(2)
    kp = JKeypoints(
        uv=jnp.asarray(rng.uniform(0, 8, (16, 2)).astype(np.float32)),
        xyz=jnp.asarray(rng.normal(size=(16, 3)).astype(np.float32)),
        score=jnp.asarray(rng.normal(size=16).astype(np.float32)),
        theta=jnp.asarray(rng.normal(size=16).astype(np.float32)),
        desc=jnp.asarray(np.where(rng.uniform(size=(16, 256)) < 0.5, 1, -1).astype(np.int8)),
        valid=jnp.asarray(rng.uniform(size=16) < 0.7),
        level=jnp.asarray(rng.integers(0, 4, 16).astype(np.int32)))
    _roundtrip(kp, interop.keypoints_from_numpy)
    depth = rng.uniform(0, 4, (6, 8)).astype(np.float32)
    depth[0, :3] = 0.0
    store = JNodeStore.create(4, 16, 256, 6, 8).insert(
        1, kp, jnp.asarray(depth), jnp.asarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)))
    src = {k: np.asarray(v) for k, v in store._asdict().items() if k != "emm_zs"}
    back = interop.to_numpy(interop.store_from_numpy(src))
    assert set(back) == set(src)
    for k in src:
        assert back[k].dtype == src[k].dtype, k
        np.testing.assert_array_equal(back[k], src[k], err_msg=k)


def test_graph_state_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tpg.GraphState)] == list(jpg.GraphState._fields)
