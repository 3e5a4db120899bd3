"""Port parity: core/alignment's weighted Kabsch fit. Its plain version
(torch.linalg.svd + det, what the CPU runs) against the JAX package's
weighted_kabsch on the same numpy-seeded problems: R and t within 1e-5,
the all-zero-weight case included (both give the identity). The CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chip_smoke import kabsch_problems  # noqa: E402
from rgbdslam_v2_tpu.core import alignment as ja  # noqa: E402
from rgbdslam_v2_tpu_torch.core import alignment as ta  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5


def _both(src, dst, w):
    ref = np.asarray(ja.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    got = ta.weighted_kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    return got.numpy(), ref


@pytest.mark.parametrize("n", [64, 300])
def test_plain_kabsch_matches_jax(n):
    got, ref = _both(*kabsch_problems(np.random.default_rng(n), 200, n))
    np.testing.assert_allclose(got[:, :3, :3], ref[:, :3, :3], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[:, :3, 3], ref[:, :3, 3], rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[:, 3], ref[:, 3])


def test_plain_kabsch_zero_weights_is_identity_in_both():
    src, dst, w = kabsch_problems(np.random.default_rng(1), 8, 300)
    got, ref = _both(src, dst, np.zeros_like(w))
    np.testing.assert_array_equal(got, np.broadcast_to(np.eye(4, dtype=np.float32), got.shape))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_horn_alignment_matches_jax():
    rng = np.random.default_rng(4)
    src, dst, _ = kabsch_problems(rng, 1, 120)
    T_j, rmse_j = ja.horn_align_trajectories(jnp.asarray(src[0]), jnp.asarray(dst[0]))
    T_t, rmse_t = ta.horn_align_trajectories(torch.from_numpy(src[0]), torch.from_numpy(dst[0]))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=0, atol=TOL)
    assert abs(float(rmse_t) - float(rmse_j)) < TOL


def test_kernel_wrapper_refuses_cpu_tensors():
    src, dst, w = (torch.from_numpy(a) for a in kabsch_problems(np.random.default_rng(2), 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ta.weighted_kabsch_cuda(src, dst, w)
    before = ta.LAUNCHES
    ta.weighted_kabsch(src, dst, w)  # CPU tensors: the plain version, no launch
    assert ta.LAUNCHES == before
