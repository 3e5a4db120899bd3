"""Port parity: pyramid resize, grid keypoint selection, the BRIEF pattern and
the OrbExtractor, against the JAX package on numpy-seeded inputs."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld, render_sequence  # noqa: E402
from rgbdslam_v2_tpu.models.orb import OrbExtractor as JOrb  # noqa: E402
from rgbdslam_v2_tpu.ops import fast as jfast, image as jimage, orb as jorb  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import detect, fast, image, orb  # noqa: E402

torch.set_num_threads(1)
CAM = (130.0, 130.0, 80.0, 60.0, 160, 120)


@pytest.mark.parametrize("shape", [(400, 533), (333, 444), (278, 370), (100, 133)])
def test_resize_matches_jax_image_resize(shape):
    """jax.image.resize antialiases when it downsamples; rtol 1e-5."""
    img = np.random.default_rng(0).uniform(0, 1, (480, 640)).astype(np.float32)
    ref = np.asarray(jimage.resize_bilinear(jnp.asarray(img), shape))
    got = image.resize_bilinear(torch.from_numpy(img), shape).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("shape", [(400, 533), (100, 133)])
def test_padded_resize_matches_unpadded(shape):
    """The pyramid writes a resize into rows padded to 4 floats: the same
    bits as the unpadded product, and so the same tolerance to JAX."""
    img = np.random.default_rng(0).uniform(0, 1, (480, 640)).astype(np.float32)
    ref = np.asarray(jimage.resize_bilinear(jnp.asarray(img), shape))
    out = detect.pitched_empty(*shape, "cpu")
    got = image.resize_bilinear(torch.from_numpy(img), shape, out=out)
    assert got is out and out.stride(0) % 4 == 0 and out.stride(0) > shape[1]
    assert torch.equal(got, image.resize_bilinear(torch.from_numpy(img), shape))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_select_keypoints_grid_exact():
    rng = np.random.default_rng(1)
    score = np.full((120, 160), -np.inf, np.float32)
    pick = rng.uniform(size=score.shape) < 0.05
    score[pick] = rng.choice([0.25, 0.5, 1.0], size=int(pick.sum()))  # many ties
    for k, grid in ((64, 4), (100, 1)):
        ref = jfast.select_keypoints_grid(jnp.asarray(score), k, grid=grid)
        got = fast.select_keypoints_grid(torch.from_numpy(score), k, grid=grid)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_brief_cells_reproduce_jax_bin_matrix():
    W = np.zeros((orb.PATCH * orb.PATCH, orb.N_ORIENT_BINS, orb.DESC_BITS), np.float32)
    cols = np.arange(orb.DESC_BITS)
    for b in range(orb.N_ORIENT_BINS):
        W[orb.BRIEF_P_CELLS[b], b, cols] += 1.0
        W[orb.BRIEF_Q_CELLS[b], b, cols] -= 1.0
    np.testing.assert_array_equal(W.reshape(jorb.BRIEF_BINS.shape), jorb.BRIEF_BINS)
    np.testing.assert_array_equal(orb.MOMENT_XY, jorb.MOMENT_XY)


def test_orb_extractor_matches_jax():
    """160x120, K=256, the JAX extractor jit-compiled as the pipeline runs it:
    uv, level, valid, descriptors and backprojected xyz bitwise equal."""
    world = SyntheticWorld.create(seed=0, texture_size=256, cam=JIntrinsics(*CAM))
    _, rgbs, depths = render_sequence(world, 2, seed=2)
    gray = (rgbs[1].astype(np.float32) @ np.float32([0.299, 0.587, 0.114]) / 255.0)
    gray = gray.astype(np.float32)
    dmap = np.where(depths[1] > 0, depths[1], np.inf).astype(np.float32)
    jorb = JOrb(max_keypoints=256, use_pallas=False)
    ref = jax.jit(lambda g, d: jorb(g, d, JIntrinsics(*CAM)))(jnp.asarray(gray),
                                                              jnp.asarray(dmap))
    got = OrbExtractor(max_keypoints=256)(torch.from_numpy(gray), torch.from_numpy(dmap),
                                          Intrinsics(*CAM))
    assert int(got.valid.sum()) > 100
    for name in ("uv", "level", "valid", "desc", "xyz"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
