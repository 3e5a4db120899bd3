"""The port's ICP rescue (rgbdslam_v2_tpu_torch/graph/rescue.py) against the
JAX package's (``_icp_rescue_body``, ``_icp_rescue_batch_kernel``,
``_retro_rescue_kernel`` in rgbdslam_v2_tpu/graph/manager.py) on the same
graph and depth store: eight JAX-rendered 160x120 orbit frames (stride-2
depth, 80x60), nodes 0-3 at their true poses and nodes 4-7 frozen on node
3, as constant-position fallback edges leave them.

Tolerances (the ICP tolerance of tests/test_torch_icp.py): transforms,
edge measurements and poses within 1e-4 (rotation entries; metres);
n_pairs within 1%; rmse within 1% relative; EMM quality within 0.01;
verdicts equal; information within 1% relative."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph import manager as jmanager  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.optim.pose_graph import GraphState as JGraphState  # noqa: E402
from rgbdslam_v2_tpu.optim.pose_graph import make_graph_state as jmake_graph  # noqa: E402

from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import rescue  # noqa: E402
from rgbdslam_v2_tpu_torch.ops.emm import emm_pool_maps  # noqa: E402

CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
CAM_SMALL = (65.0, 65.0, 40.0, 30.0, 80, 60)
N_CAP, E_CAP = 16, 32
ITERS, EMM_SKIP, SIGMA, OBS = 12, 2, 0.01, 0.5
FB_SLOT = {k: 10 + k for k in range(4, 8)}  # fallback edge slot of node k


@pytest.fixture(scope="module")
def scene():
    """(true poses (8, 4, 4), stride-2 depths (8, 60, 80), numpy graph)."""
    world = JWorld.create(seed=0, texture_size=128, cam=JIntrinsics(*CAM))
    poses, _, depths = jrender(world, 8, seed=2, depth_noise_sigma=0.01)
    small = np.ascontiguousarray(depths[:, ::2, ::2]).astype(np.float32)
    g = {k: np.array(v) for k, v in jmake_graph(N_CAP, E_CAP)._asdict().items()}
    g["poses"][:4] = poses[:4]
    g["poses"][4:8] = poses[3]  # frozen by constant-position edges
    g["node_active"][:8] = True
    for k, e in FB_SLOT.items():
        g["edge_i"][e], g["edge_j"][e], g["edge_active"][e] = k - 1, k, True
        g["edge_info"][e] = np.eye(6) * 100.0
    return np.asarray(poses, np.float32), small, g


def _jgraph(g):
    return JGraphState(**{k: jnp.asarray(v) for k, v in g.items()})


def _cmp_T(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], atol=1e-4)  # rotation
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], atol=1e-4)  # metres


def _cmp_result(got, want):
    T, rmse, n_pairs, conv, q, frac = (np.asarray(x) for x in want)
    _cmp_T(got.transform.numpy(), T)
    assert np.all(np.abs(got.n_pairs.numpy() - n_pairs) <= 0.01 * n_pairs)  # 1%
    np.testing.assert_allclose(got.rmse.numpy(), rmse, rtol=1e-2)
    np.testing.assert_array_equal(got.converged.numpy(), conv)
    np.testing.assert_allclose(got.emm_quality.numpy(), q, atol=1e-2)
    np.testing.assert_allclose(got.emm_inlier_frac.numpy(), frac, atol=1e-2)


@pytest.mark.parametrize("variant", ["gicp", "point_to_plane"])
def test_icp_rescue_body_matches_jax(scene, variant):
    """One candidate (the predecessor), seeded at identity: the default
    path's rescue of a failed predecessor match."""
    _, small, _ = scene
    want = jmanager._icp_rescue_kernel(
        jnp.eye(4), jnp.asarray(small[5]), jnp.asarray(small[4]), JIntrinsics(*CAM_SMALL),
        ITERS, EMM_SKIP, SIGMA, variant)
    got = rescue.icp_rescue_body(torch.eye(4)[None], torch.from_numpy(small[5]),
                                 torch.from_numpy(small[4:5]), Intrinsics(*CAM_SMALL), ITERS,
                                 EMM_SKIP, SIGMA, variant)
    _cmp_result(got, [np.asarray(x)[None] for x in want])
    assert bool(got.converged[0]) and float(got.emm_quality[0]) > OBS


def test_icp_rescue_batch_matches_jax(scene):
    """The default path's batched rescue: B candidates at once, seeds from
    failed RANSAC transforms (here the true motion, perturbed) or identity;
    pool maps from the store's rows equal the computed ones."""
    poses, small, _ = scene
    new, cands = 6, [5, 4, 2, 5]
    seeds = np.stack([np.linalg.inv(poses[c]) @ poses[new] if k % 2 else np.eye(4)
                      for k, c in enumerate(cands)]).astype(np.float32)
    seeds[1, :3, 3] += 0.02
    want = jmanager._icp_rescue_batch_kernel(
        jnp.asarray(seeds), jnp.asarray(small[new]), jnp.asarray(small[cands]),
        JIntrinsics(*CAM_SMALL), ITERS, EMM_SKIP, SIGMA, "gicp")
    d = torch.from_numpy(small[cands])
    got = rescue.icp_rescue_body(torch.from_numpy(seeds), torch.from_numpy(small[new]), d,
                                 Intrinsics(*CAM_SMALL), ITERS, EMM_SKIP, SIGMA, "gicp",
                                 cand_lohi=emm_pool_maps(d).reshape(len(cands), -1))
    _cmp_result(got, want)


def _port_retro(g, small, new_ids, prev):
    graph = interop.graph_from_numpy(g)
    depth = torch.from_numpy(small.reshape(len(small), -1))
    depth = torch.cat([depth, torch.zeros(N_CAP - len(small), depth.shape[1])])
    lohi = emm_pool_maps(depth.view(N_CAP, 60, 80)).reshape(N_CAP, -1)
    flags, last = rescue.retro_rescue(graph, depth, lohi, new_ids, [FB_SLOT[k] for k in new_ids],
                                      prev, Intrinsics(*CAM_SMALL), ITERS, EMM_SKIP, SIGMA,
                                      "gicp", OBS)
    return graph, flags.numpy(), last


def _jax_retro(g, small, new_ids, prev0, cap):
    n = len(new_ids)
    ids = list(new_ids) + [new_ids[0]] * (cap - n)
    depth = np.zeros((N_CAP, 60 * 80), np.float32)
    depth[: len(small)] = small.reshape(len(small), -1)
    ids32 = np.asarray(ids, np.int32)
    graph, flags, last = jmanager._retro_rescue_kernel(
        _jgraph(g), jnp.asarray(depth), ids32, ids32 - 1,
        np.asarray([FB_SLOT[k] for k in ids], np.int32),
        np.asarray([True] * n + [False] * (cap - n)),
        prev0, JIntrinsics(*CAM_SMALL), ITERS, EMM_SKIP, SIGMA, "gicp", OBS)
    return {k: np.asarray(v) for k, v in graph._asdict().items()}, np.asarray(flags), last


def _cmp_retro(port, jax_out, new_ids):
    graph, flags, _ = port
    jg, jflags, _ = jax_out
    n = len(new_ids)
    np.testing.assert_array_equal(flags[:, 0], jflags[:n, 0])  # verdicts
    assert np.all(np.abs(flags[:, 1] - jflags[:n, 1]) <= 0.01 * jflags[:n, 1])  # n_pairs 1%
    np.testing.assert_allclose(flags[:, 2], jflags[:n, 2], rtol=1e-2)  # rmse
    np.testing.assert_allclose(flags[:, 3], jflags[:n, 3], atol=1e-2)  # EMM quality
    _cmp_T(graph.poses.numpy(), jg["poses"])
    _cmp_T(graph.edge_meas.numpy(), jg["edge_meas"])
    np.testing.assert_allclose(graph.edge_info.numpy(), jg["edge_info"], rtol=1e-2)


def _no_chain():
    return (torch.eye(4), torch.tensor(False), 0), (jnp.eye(4), jnp.asarray(False), np.int32(0))


def test_retro_rescue_matches_jax_and_padding_writes_nothing(scene):
    """Nodes 4 and 5 in one dispatch of 4 rows (2 of padding): the same
    verdicts, edge rows and poses; every row the rescue did not accept,
    padding included, is as it was; a short chunk ends the chain as the
    JAX padding rows do."""
    poses, small, g = scene
    prev, jprev = _no_chain()
    port = _port_retro(g, small, [4, 5], prev)
    jax_out = _jax_retro(g, small, [4, 5], jprev, cap=4)
    _cmp_retro(port, jax_out, [4, 5])
    graph, flags, _ = port
    assert flags[:, 0].all(), flags  # both rescued
    untouched = np.ones(E_CAP, bool)
    untouched[[FB_SLOT[4], FB_SLOT[5]]] = False
    np.testing.assert_array_equal(graph.edge_meas.numpy()[untouched], g["edge_meas"][untouched])
    np.testing.assert_array_equal(graph.edge_info.numpy()[untouched], g["edge_info"][untouched])
    keep = np.ones(N_CAP, bool)
    keep[[4, 5]] = False
    np.testing.assert_array_equal(graph.poses.numpy()[keep], g["poses"][keep])
    # the rescued poses follow the true motion (constant-velocity seeds)
    assert np.abs(graph.poses.numpy()[5, :3, 3] - poses[5, :3, 3]).max() < 0.02
    assert not bool(jax_out[2][1])  # JAX: the padding rows end the chain


def test_retro_rescue_chain_carries_across_dispatches(scene):
    """Nodes 4-7 in two full dispatches of 2: the second seeds node 6 from
    the first's last rescue (prev), in both packages."""
    poses, small, g = scene
    prev, jprev = _no_chain()
    port1 = _port_retro(g, small, [4, 5], prev)
    jax1 = _jax_retro(g, small, [4, 5], jprev, cap=2)
    _cmp_retro(port1, jax1, [4, 5])
    g2 = interop.to_numpy(port1[0])
    (lT, lok), (jT, jok) = port1[2], jax1[2]
    assert bool(lok) and bool(jok)
    _cmp_T(lT.numpy(), jT)
    jg2 = {k: np.array(v) for k, v in jax1[0].items()}
    port2 = _port_retro(g2, small, [6, 7], (lT, lok, 5))
    jax2 = _jax_retro(jg2, small, [6, 7], (jT, jok, np.int32(5)), cap=2)
    _cmp_retro(port2, jax2, [6, 7])
    assert port2[1][:, 0].all()
    # the chained pose of node 7 tracks the truth
    assert np.abs(port2[0].poses.numpy()[7, :3, 3] - poses[7, :3, 3]).max() < 0.03
