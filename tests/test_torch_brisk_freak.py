"""Port parity for the BRISK and FREAK families: the patterns and their
constants, ``describe_patches_brisk`` / ``describe_patches_freak``, the
``OrbExtractor`` with ``descriptor="brisk"`` / ``"freak"`` and the
manager's family selection, against the JAX package on numpy-seeded
inputs; then the JAX package's own descriptor properties
(``tests/test_features.py``) on the port.

Tolerances, each stated at its assert: the pair tables and gradient
coefficients are exact; the footprints are exact wherever the JAX
constant is a normal float32 (XLA flushes subnormals to zero, the port's
constant holds zeros there); descriptor bits are exact, with the number of
flipped bits asserted (0 here: the (K, 1024) @ (1024, 30 x S) sums round
differently in torch and XLA, by far less than any comparison's margin on
these inputs); theta within 5e-5 rad (atan2 of those sums).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.graph.manager import GraphManager as JManager  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld, render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.models.orb import OrbExtractor as JOrb  # noqa: E402
from rgbdslam_v2_tpu.ops import brisk as jbrisk, freak as jfreak  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.manager import GraphManager  # noqa: E402
from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor, min_depth_map  # noqa: E402
from rgbdslam_v2_tpu_torch.models.sift import SiftExtractor  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import brisk, freak, matching, orb  # noqa: E402

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)
T = torch.from_numpy
FAMILIES = {"brisk": (jbrisk, brisk, "describe_patches_brisk", "SHORT_I", "SHORT_J"),
            "freak": (jfreak, freak, "describe_patches_freak", "PAIR_I", "PAIR_J")}


@pytest.mark.parametrize("family", ["brisk", "freak"])
def test_pattern_constants_match_jax(family):
    jmod, tmod, _, pi, pj = FAMILIES[family]
    for name in ("PATTERN_XY", "PATTERN_SIGMA", "GRAD_CX", "GRAD_CY", pi, pj):
        np.testing.assert_array_equal(getattr(tmod, name), getattr(jmod, name), err_msg=name)
    ref = jmod.FOOTPRINTS
    got = brisk.build_footprints(tmod.PATTERN_XY, tmod.PATTERN_SIGMA)
    normal = ref >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(got[normal], ref[normal])
    assert (got[~normal] == 0).all()


@pytest.mark.parametrize("family", ["brisk", "freak"])
@pytest.mark.parametrize("oriented", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_describe_patches_matches_jax(family, oriented, seed):
    """300 random patches, and 300 of a block texture: 0 of 153600 bits
    flipped, theta within 5e-5 rad."""
    jmod, _, fn, _, _ = FAMILIES[family]
    rng = np.random.default_rng(seed)
    if seed == 0:
        patches = rng.uniform(0, 1, (300, 32, 32)).astype(np.float32)
    else:
        tex = np.kron(rng.uniform(0, 1, (40, 40)), np.ones((6, 6))).astype(np.float32)
        ys, xs = rng.integers(0, 240 - 32, 300), rng.integers(0, 240 - 32, 300)
        patches = np.stack([tex[y : y + 32, x : x + 32] for y, x in zip(ys, xs)])
    jth, jd = jax.jit(lambda p: getattr(jmod, fn)(p, oriented))(jnp.asarray(patches))
    th, d = getattr(FAMILIES[family][1], fn)(T(patches), oriented)
    assert d.dtype == torch.int8 and d.shape == (300, 512)
    flipped = int((d.numpy() != np.asarray(jd)).sum())
    assert flipped == 0, flipped
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=0, atol=5e-5)


@pytest.fixture(scope="module")
def frame():
    world = JWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    _, rgbs, depths = jrender(world, 2, seed=2)
    gray = (rgbs[1].astype(np.float32) @ np.float32([0.299, 0.587, 0.114]) / 255.0)
    return gray.astype(np.float32), np.where(depths[1] > 0, depths[1], np.inf).astype(np.float32)


@pytest.mark.parametrize("family", ["brisk", "freak"])
def test_extractor_matches_jax(frame, family):
    """OrbExtractor(descriptor=family), K=256, against the JAX extractor
    jit-compiled: positions, levels, validity and xyz exact (the detector
    is ORB's), 512-bit descriptors with 0 bits flipped, theta within 5e-5
    rad."""
    gray, dmap = frame
    ref = jax.jit(lambda g, d: JOrb(max_keypoints=256, use_pallas=False, descriptor=family)(
        g, d, JIntrinsics(*CAM)))(jnp.asarray(gray), jnp.asarray(dmap))
    got = OrbExtractor(max_keypoints=256, descriptor=family)(T(gray), T(dmap), Intrinsics(*CAM))
    assert int(got.valid.sum()) > 100 and got.desc.shape == (256, 512)
    for name in ("uv", "level", "valid", "xyz"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int((got.desc.numpy() != np.asarray(ref.desc)).sum()) == 0
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta), rtol=0, atol=5e-5)


SMALL = dict(max_keypoints=64, tpu_max_nodes=4, tpu_max_edges=32, tpu_candidate_batch=2)


@pytest.mark.parametrize("over", [
    {"feature_extractor_type": "BRISK"}, {"feature_extractor_type": "FREAK"},
    {"feature_extractor_type": "BRIEF"}, {"feature_extractor_type": "SURF"},
    {"feature_detector_type": "SIFTGPU"}, {"feature_extractor_type": "SIFT"},
    {"feature_extractor_type": "BRISK", "tpu_descriptor_dtype": "bf16"},
    {"feature_detector_type": "SIFT", "tpu_descriptor_dtype": "bf16"},
])
def test_family_selection_matches_jax(over):
    """The manager picks the JAX package's family, orientation, descriptor
    width and store dtype: SIFT wins if either side asks for it (its
    store is float32 whatever tpu_descriptor_dtype says), BRIEF is
    unoriented, SURF falls back to ORB."""
    params = {**SMALL, **over}
    jm = JManager(JIntrinsics(*CAM), JParams(dict(params)))
    tm = GraphManager(Intrinsics(*CAM), ParameterServer(dict(params)), device="cpu")
    assert tuple(tm.store.desc.shape) == tuple(jm.store.desc.shape)
    assert str(tm.store.desc.dtype).split(".")[-1] == str(jm.store.desc.dtype)
    if isinstance(tm.extractor, SiftExtractor):
        assert "Sift" in type(jm.extractor).__name__
        assert tm.extractor.use_root_sift == jm.extractor.use_root_sift
        assert tm._base_threshold is None
    else:
        assert (tm.extractor.descriptor, tm.extractor.oriented) == (
            jm.extractor.descriptor, jm.extractor.oriented)


# ---- the JAX package's descriptor properties (tests/test_features.py) ----

def _block_texture(seed, h=240, w=320):
    rng = np.random.default_rng(seed)
    return np.kron(rng.uniform(0, 1, (h // 8, w // 8)), np.ones((8, 8))).astype(np.float32)


UV = np.float32([[100.0, 100.0], [150.0, 80.0], [200.0, 160.0], [60.0, 60.0]])


@pytest.mark.parametrize("family", ["brisk", "freak"])
def test_descriptor_properties(family):
    """512-bit +/-1 descriptors, stable under translation (diagonal Hamming
    < 50 BRISK / 60 FREAK, off-diagonal 20 more), rotation-steered (a
    90-degree rotation keeps distances 20 below the unoriented variant's)."""
    describe = getattr(FAMILIES[family][1], FAMILIES[family][2])
    img = T(_block_texture(6))
    patches = orb.extract_patches(img, T(UV))
    _, d1 = describe(patches)
    assert set(np.unique(d1.numpy()).tolist()) <= {-1, 1}
    shifted = torch.roll(img, (5, 9), (0, 1))
    _, d2 = describe(orb.extract_patches(shifted, T(UV + np.float32([[9.0, 5.0]]))))
    ham = matching.descriptor_distances(d1, d2).numpy()
    diag = np.diag(ham)
    assert (diag < (50 if family == "brisk" else 60)).all()
    assert ((ham + np.eye(4) * 1e9).min(1) > diag + 20).all()
    W = img.shape[1]
    rot = torch.rot90(img)
    uv_rot = T(np.stack([UV[:, 1], (W - 1) - UV[:, 0]], -1).astype(np.float32))
    pr = orb.extract_patches(rot, uv_rot)
    _, dr_o = describe(pr, True)
    _, d1_u = describe(patches, False)
    _, dr_u = describe(pr, False)
    ham_o = np.diag(matching.descriptor_distances(d1, dr_o).numpy())
    ham_u = np.diag(matching.descriptor_distances(d1_u, dr_u).numpy())
    assert ham_o.mean() < ham_u.mean() - 20


def test_freak_is_not_brisk():
    """FREAK bits are not a permutation of BRISK bits: agreement on the same
    patches stays near chance."""
    patches = orb.extract_patches(T(_block_texture(6)), T(UV))
    agree = (freak.describe_patches_freak(patches)[1] == brisk.describe_patches_brisk(
        patches)[1]).float().mean()
    assert 0.3 < float(agree) < 0.7


@pytest.mark.parametrize("family", ["brisk", "freak"])
def test_extractor_end_to_end(family):
    """128 keypoints of 512 bits on a 320x240 block texture, more than
    half valid, > 90% distinct."""
    rng = np.random.default_rng(3)
    depth = T(rng.uniform(0.5, 3.0, (240, 320)).astype(np.float32))
    ex = OrbExtractor(max_keypoints=128, descriptor=family)
    assert ex.desc_bits == 512
    kp = ex(T(_block_texture(3)), min_depth_map(depth, depth > 0),
            Intrinsics(260.0, 260.0, 160.0, 120.0, 320, 240))
    assert kp.desc.shape == (128, 512)
    k = kp.valid.numpy()
    assert k.sum() > 64
    assert len(np.unique(kp.desc.numpy()[k], axis=0)) > 0.9 * k.sum()
