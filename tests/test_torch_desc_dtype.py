"""Descriptor storage (``tpu_descriptor_dtype`` int8 / bf16 / float32, and
SIFT's 128 float32) in the port, against the JAX package where it has an
answer.

* Matching: +/-1 descriptors stored as bf16 or float32 go through the
  squared-L2 branch, exactly 4 x the int8 Hamming distance, so
  ``match_descriptors`` keeps the same matches in the same order (asserted
  exactly); the bf16 distances equal the JAX package's bitwise.
* The pipeline: a bf16 or float32 store gives poses bitwise equal to the
  int8 store's on the CPU (same matches, same RANSAC draws), for the
  256-bit ORB and the 512-bit BRISK families.
* State: ``save_state`` / ``load_state`` round-trip a SIFT store and a bf16
  store exactly; a checkpoint the JAX package wrote of either loads into
  the port with equal arrays (numpy writes JAX's bfloat16 as raw 2-byte
  words, read without ml_dtypes); ``save_features`` writes the store's
  width and dtype as the JAX package does, an empty map too.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.ops import matching as jmatching  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch import interop  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import matching  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
DTYPES = {"bf16": torch.bfloat16, "float32": torch.float32}
PARAMS = dict(
    max_keypoints=256, tpu_max_nodes=32, tpu_max_edges=256, tpu_candidate_batch=4,
    ransac_iterations=100, min_matches=12, optimizer_skip_step=10, keep_all_nodes=True,
    observability_threshold=0.5, tpu_drain_pipelined=False,
)
N = 20


def _pm1(rng, shape):
    return np.where(rng.uniform(size=shape) < 0.5, 1, -1).astype(np.int8)


@pytest.mark.parametrize("dtype", ["bf16", "float32"])
@pytest.mark.parametrize("bits", [256, 512])
def test_binary_stores_give_equal_matches(dtype, bits):
    """Query against 3 train sets with planted near matches, duplicates and
    ties: bf16 / float32 distances are exactly 4 x Hamming, and the
    matches (indices, validity, order) equal the int8 store's."""
    rng = np.random.default_rng(bits)
    a = _pm1(rng, (120, bits))
    b = _pm1(rng, (3, 150, bits))
    b[0, :60] = a[:60]
    flip = rng.uniform(size=(60, bits)) < 0.1
    b[0, :60][flip] *= -1
    b[1, 5] = b[1, 6]  # a duplicate train descriptor
    b[2, :40] = a[40:80]
    va = rng.uniform(size=120) < 0.9
    vb = rng.uniform(size=(3, 150)) < 0.9
    ham = matching.descriptor_distances(torch.from_numpy(a), torch.from_numpy(b))
    ref = matching.match_descriptors(torch.from_numpy(a), torch.from_numpy(va),
                                     torch.from_numpy(b), torch.from_numpy(vb), 100, 0.9)
    dt = DTYPES[dtype]
    a2, b2 = torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt)
    assert torch.equal(matching.descriptor_distances(a2, b2), 4.0 * ham)
    got = matching.match_descriptors(a2, torch.from_numpy(va), b2, torch.from_numpy(vb), 100,
                                     0.9)
    for name in ("src_idx", "dst_idx", "valid"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.equal(got.dist, 4.0 * ref.dist)
    assert int(ref.valid.sum()) > 60


@pytest.mark.parametrize("bits", [256, 512])
def test_bf16_distances_match_jax(bits):
    """The JAX package's bf16 L2 distances, bitwise."""
    rng = np.random.default_rng(bits + 1)
    a, b = _pm1(rng, (50, bits)), _pm1(rng, (60, bits))
    ref = np.asarray(jmatching.descriptor_distances(jnp.asarray(a, jnp.bfloat16),
                                                    jnp.asarray(b, jnp.bfloat16)))
    got = matching.descriptor_distances(torch.from_numpy(a).bfloat16(),
                                        torch.from_numpy(b).bfloat16())
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


@pytest.fixture(scope="module")
def seq():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, N, seed=2)
    return np.asarray(poses), rgbs, depths, np.arange(N) / 30.0


def _port(**over):
    return SlamPipeline(Intrinsics(*CAM), ParameterServer({**PARAMS, **over}), device="cpu")


@pytest.mark.parametrize("family", ["ORB", "BRISK"])
def test_store_dtypes_give_equal_poses(seq, family):
    """20 frames keep-all: int8, bf16 and float32 stores, bitwise equal
    poses and equal statistics."""
    poses, rgbs, depths, stamps = seq
    runs = {}
    for dtype in ("int8", "bf16", "float32"):
        pipe = _port(feature_extractor_type=family, tpu_descriptor_dtype=dtype)
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        runs[dtype] = (pipe.manager.poses(), pipe.manager.statistics(), pipe.manager.store.desc)
    for dtype in ("bf16", "float32"):
        np.testing.assert_array_equal(runs[dtype][0], runs["int8"][0])
        assert runs[dtype][1] == runs["int8"][1]
        assert runs[dtype][2].dtype == DTYPES[dtype]
        assert torch.equal(runs[dtype][2].float(), runs["int8"][2].float())
    assert runs["int8"][1]["sequential_edges"] > 2 * N


STORES = {"sift": dict(feature_detector_type="SIFTGPU", feature_extractor_type="SIFTGPU",
                       nn_distance_ratio=0.9),
          "bf16": dict(tpu_descriptor_dtype="bf16")}


def _store_equal(a, b):
    for name in ("uv", "xyz", "desc", "kp_valid", "depth", "emm_lohi", "color"):
        assert getattr(a, name).dtype == getattr(b, name).dtype, name
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("store", ["sift", "bf16"])
def test_state_round_trip(seq, tmp_path, store):
    """save_state, load_state into a fresh pipeline: the store (128 float32
    or bf16 descriptors), poses and statistics equal, and the continued run
    equals the uninterrupted one bitwise."""
    poses, rgbs, depths, stamps = seq
    full = _port(**STORES[store])
    full.run_arrays(rgbs, depths, stamps, gt_poses=poses)
    half = _port(**STORES[store])
    half.run_arrays(rgbs[:10], depths[:10], stamps[:10], gt_poses=poses)
    half.manager.save_state(tmp_path / "state.npz")
    with np.load(tmp_path / "state.npz") as data:
        desc = data["store_desc"]
        assert desc.dtype == (np.float32 if store == "sift" else np.dtype("V2"))
    cont = _port(**STORES[store])
    cont.manager.load_state(tmp_path / "state.npz")
    _store_equal(cont.manager.store, half.manager.store)
    assert cont.manager.statistics() == half.manager.statistics()
    for k in range(10, N):
        cont.process_frame(rgbs[k], depths[k], stamps[k])
    np.testing.assert_array_equal(cont.manager.poses(), full.manager.poses())
    _store_equal(cont.manager.store, full.manager.store)


@pytest.mark.parametrize("store", ["sift", "bf16"])
def test_jax_checkpoint_and_features_of_the_store(seq, tmp_path, store):
    """A JAX checkpoint of a SIFT or bf16 store (6 frames) loads into the
    port with equal arrays; save_features writes what the JAX package
    writes for that state (descriptors bitwise, bf16 as its raw words), and
    the store's width for an empty map."""
    poses, rgbs, depths, stamps = seq
    params = {**PARAMS, **STORES[store]}
    jpipe = JPipeline(JIntrinsics(*CAM), JParams(dict(params)))
    jpipe.run_arrays(rgbs[:6], depths[:6], stamps[:6], gt_poses=poses)
    jm = jpipe.manager
    jm.save_state(tmp_path / "jax.npz")
    tpipe = _port(**STORES[store])
    tm = tpipe.manager
    tm.load_state(tmp_path / "jax.npz")
    np.testing.assert_array_equal(tm.poses(), jm.poses())
    assert tm.store.desc.dtype == (torch.float32 if store == "sift" else torch.bfloat16)
    for name in ("uv", "xyz", "desc", "kp_valid", "depth"):
        got = interop.tensor_to_numpy(getattr(tm.store, name))
        ref = np.asarray(getattr(jm.store, name))
        if ref.dtype.kind == "V" or str(ref.dtype) == "bfloat16":
            got, ref = got.view(np.uint16), ref.view(np.uint16)
        np.testing.assert_array_equal(got, ref, err_msg=name)
    jpipe.save_features(tmp_path / "jax.features.npz")
    tpipe.save_features(tmp_path / "port.features.npz")
    with np.load(tmp_path / "jax.features.npz") as a, np.load(tmp_path / "port.features.npz") as b:
        assert a["descriptors"].dtype == b["descriptors"].dtype
        assert a["descriptors"].shape == b["descriptors"].shape
        assert a["descriptors"].shape[1] == (128 if store == "sift" else 256)
        np.testing.assert_array_equal(a["descriptors"].view(np.uint8),
                                      b["descriptors"].view(np.uint8))
    _port(**STORES[store]).save_features(tmp_path / "empty.npz")
    with np.load(tmp_path / "empty.npz") as e:
        assert e["descriptors"].shape == (0, 128 if store == "sift" else 256)
