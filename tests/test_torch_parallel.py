"""The port's parallel/mesh.py and parallel/sharded.py against the JAX
package's (JAX on its 8 virtual CPU devices, the port on CPU shards).

Mesh: CPU shards of any count; a request for cards without CUDA raises
(no fallback). Sharded LM: on the loop graph of tests/test_pose_graph.py,
one iteration over 8 shards agrees with the port's lm_iteration and with
the JAX sharded_lm_iteration within the JAX test's tolerances (chi2 rel
1e-2 before, 5e-2 after, poses 1e-3); sharded_optimize cuts chi2 below a
tenth. Sharded compare: equal, bit for bit, to the per-shard
compare_to_candidates calls concatenated; on identical geometry it finds
the identity (the JAX test's case). GraphManager with tpu_mesh_devices=2
on the CPU routes its comparisons through the sharded compare and stays in
the JAX package's band: accepted edges within 25%, protocol L4 < 0.03 m
in both.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.parallel import candidate_mesh as jmesh  # noqa: E402
from rgbdslam_v2_tpu.parallel import sharded_lm_iteration as jsharded_lm  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.compare import compare_to_candidates  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.node_store import NodeStore  # noqa: E402
from rgbdslam_v2_tpu_torch.models.types import Keypoints  # noqa: E402
from rgbdslam_v2_tpu_torch.optim.pose_graph import edge_chi2, lm_iteration  # noqa: E402
from rgbdslam_v2_tpu_torch.parallel import (DeviceMesh, candidate_mesh, sharded,  # noqa: E402
                                            sharded_compare, sharded_lm_iteration)
from rgbdslam_v2_tpu_torch.parallel.sharded import shard_generators, sharded_optimize  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_cpu_mesh_shards(n):
    mesh = candidate_mesh(n, platform="cpu")
    assert mesh.size == n and mesh.axis_name == "c"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    blocks = mesh.blocks(8 * n)
    assert [(lo, hi) for _, lo, hi in blocks] == [(8 * k, 8 * k + 8) for k in range(n)]
    if n > 1:
        with pytest.raises(ValueError, match="not divisible"):
            mesh.blocks(8 * n + 1)


@pytest.mark.parametrize("n", [None, 1, 2])
def test_card_mesh_without_cuda_raises(n):
    """No fallback to CPU devices (the JAX candidate_mesh falls back)."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal without CUDA")
    with pytest.raises(ValueError, match="have 0"):
        candidate_mesh(n)
    with pytest.raises(ValueError, match="have 0"):
        candidate_mesh(n, platform="cuda")


# ----------------------------------------------------------------------
def _loop_graph():
    from tests.test_pose_graph import _build_loop_graph

    g, _, _ = _build_loop_graph(n_nodes=20, drift=0.02)
    return g


@pytest.fixture(scope="module")
def loop_graph():
    jg = _loop_graph()
    return jg, interop.graph_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})


def test_sharded_lm_matches_lm_iteration_and_jax(loop_graph):
    """Reduction order differs: JAX's tolerances (tests/test_parallel.py)."""
    jg, g = loop_graph
    lam = torch.tensor(1e-4)
    p1, _, cb1, ca1 = lm_iteration(g, lam, 1.0, 32, solver="pcg")
    p8, _, cb8, ca8 = sharded_lm_iteration(candidate_mesh(8, platform="cpu"), g, lam, 1.0, 32)
    jg8, _, jcb, jca = jsharded_lm(jmesh(8, platform="cpu"), jg, jnp.asarray(1e-4), 1.0, 32)
    for cb, ca, poses in ((float(cb1), float(ca1), p1.numpy()),
                          (float(jcb), float(jca), np.asarray(jg8.poses))):
        assert abs(cb - float(cb8)) < 1e-2 * max(cb, 1.0)
        assert abs(ca - float(ca8)) < 5e-2 * max(ca, 1.0)
        np.testing.assert_allclose(poses[:20], p8.numpy()[:20], atol=1e-3)
    assert float(ca8) < float(cb8)


def test_sharded_optimize_closes_loop(loop_graph):
    _, g = loop_graph
    before = float(edge_chi2(g).sum())
    g2, chi2 = sharded_optimize(candidate_mesh(8, platform="cpu"), g, iterations=20)
    assert float(chi2) < 0.1 * before
    assert float(edge_chi2(g2).sum()) == pytest.approx(float(chi2), rel=1e-4)


# ----------------------------------------------------------------------
K, D = 64, 256
CAM_SMALL = Intrinsics(fx=65.0, fy=65.0, cx=20.0, cy=15.0, width=40, height=30)
KW = dict(max_matches=32, n_hypotheses=32, min_inliers=8)


def _kp(seed):
    r = np.random.default_rng(seed)
    desc = np.where(r.uniform(size=(K, D)) > 0.5, 1, -1).astype(np.int8)
    xyz = np.stack([r.uniform(-1, 1, K), r.uniform(-1, 1, K), r.uniform(1, 3, K)], -1)
    return Keypoints(uv=torch.zeros(K, 2), xyz=torch.tensor(xyz, dtype=torch.float32),
                     score=torch.ones(K), theta=torch.zeros(K), desc=torch.tensor(desc),
                     valid=torch.ones(K, dtype=torch.bool),
                     level=torch.zeros(K, dtype=torch.int32))


def _store(seeds):
    store = NodeStore.create(16, K, D, 30, 40, device="cpu")
    depth = torch.full((30, 40), 2.0)
    for i, s in enumerate(seeds):
        store.insert(torch.tensor([i]), _kp(s), depth, torch.zeros(30, 40, 3, dtype=torch.uint8))
    return store, depth


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_compare_equals_per_shard_calls(n):
    """Exact: shard k compares its contiguous candidates with
    shard_generators' k-th generator; the caller's generator advances as
    shard_generators advances it."""
    store, depth = _store(range(8))
    kp = _kp(3)  # matches node 3 exactly, the others by chance
    cand = torch.tensor([3, 0, 1, 2, 4, 5, 6, 7])
    mesh = candidate_mesh(n, platform="cpu")
    gen = torch.Generator().manual_seed(11)
    ref_gen = torch.Generator()
    ref_gen.set_state(gen.get_state())
    got = sharded_compare(mesh, kp, depth, store, cand, gen, CAM_SMALL, **KW)
    gens = shard_generators(ref_gen, mesh.devices)
    parts = [compare_to_candidates(kp, depth, store, cand[lo:hi], g, CAM_SMALL, **KW)
             for (_, lo, hi), g in zip(mesh.blocks(8), gens)]
    for name, a in got._asdict().items():
        if a is None:
            continue
        assert torch.equal(a, torch.cat([getattr(p, name) for p in parts])), name
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert bool(got.ransac_ok[0]) and float(got.transform[0, :3, 3].abs().max()) < 1e-2


def test_sharded_compare_finds_identity():
    """The JAX test's case: identical descriptors and geometry in every
    candidate, 8 shards: the identity for each."""
    store, depth = _store([1] * 8)
    res = sharded_compare(candidate_mesh(8, platform="cpu"), _kp(1), depth, store,
                          torch.arange(8), torch.Generator().manual_seed(0), CAM_SMALL, **KW)
    assert res.transform.shape == (8, 4, 4)
    assert bool(res.ransac_ok.all())
    assert float(res.transform[:, :3, 3].abs().max()) < 1e-2


def test_sharded_compare_copies_rows_to_other_devices(monkeypatch):
    """A shard on another device than the store's gets a copy of its
    candidates' rows and local indices, and the same result as reading the
    store in place (cpu:0 counts as another device than the store's cpu)."""
    store, depth = _store(range(8))
    kp, cand = _kp(5), torch.tensor([5, 1, 2, 3])
    seen = []
    real = sharded.compare_to_candidates

    def spy(kp_, ds, st, ci, *a, **kw):
        seen.append((st.uv.shape[0], ci.tolist()))
        return real(kp_, ds, st, ci, *a, **kw)

    monkeypatch.setattr(sharded, "compare_to_candidates", spy)
    res = {}
    for other in ("cpu", "cpu:0"):
        res[other] = sharded_compare(DeviceMesh(("cpu", other)), kp, depth, store, cand,
                                     torch.Generator().manual_seed(2), CAM_SMALL, **KW)
    assert seen == [(16, [5, 1]), (16, [2, 3]), (16, [5, 1]), (2, [0, 1])]
    for name, x in res["cpu"]._asdict().items():
        if x is not None:
            assert torch.equal(x, getattr(res["cpu:0"], name)), name


# ----------------------------------------------------------------------
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
N_FRAMES = 14
PARAMS = dict(
    max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
    ransac_iterations=128, min_matches=12, keep_all_nodes=False, backend_solver="pcg",
    optimizer_skip_step=1, tpu_mesh_devices=2,
)


def test_manager_mesh_route_matches_jax(tmp_path, monkeypatch):
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N_FRAMES, seed=2)
    poses = np.asarray(poses)
    stamps = np.arange(N_FRAMES) / 30.0
    calls = []
    real = sharded.sharded_compare
    monkeypatch.setattr(sharded, "sharded_compare",
                        lambda mesh, *a, **kw: calls.append(mesh.size) or real(mesh, *a, **kw))
    out = {}
    for name, pipe in (("jax", JPipeline(JIntrinsics(*CAM), JParams(dict(PARAMS)))),
                       ("torch", SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(PARAMS)),
                                              device="cpu"))):
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        rep = pipe.evaluation_protocol(tmp_path / name, gt_stamps=list(stamps),
                                       gt_xyz=poses[:, :3, 3])
        st = pipe.manager.statistics()
        out[name] = (rep.ate_rmse[4], st["sequential_edges"] + st["loop_edges"])
    assert calls and set(calls) == {2}  # every comparison went through the mesh
    assert out["torch"][0] < 0.03 and out["jax"][0] < 0.03, out
    assert abs(out["torch"][1] - out["jax"][1]) <= 0.25 * out["jax"][1], out
