"""Port parity: FAST+Harris+NMS corner scoring.

The port's plain version (ops/fast.detect_corners) against the JAX XLA
version and against the Pallas kernel run in interpret mode: the corner
mask equal, scores within rtol 2e-4 (the tolerance of
tests/test_pallas_detect.py). The hand-written CUDA kernel against the plain
version is in tests/test_torch_kernels_cuda.py, which needs no JAX.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.ops.fast import detect_corners as jax_detect  # noqa: E402
from rgbdslam_v2_tpu_torch import backend  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import detect, fast  # noqa: E402

torch.set_num_threads(1)


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.kron(rng.uniform(0, 1, (h // 16 + 1, w // 16 + 1)), np.ones((16, 16)))[:h, :w]
    return (img + rng.normal(0, 0.02, img.shape)).astype(np.float32)


def _assert_same_corners(ref, got):
    mref, mgot = np.isfinite(ref), np.isfinite(got)
    np.testing.assert_array_equal(mref, mgot)
    assert mref.sum() > 10
    np.testing.assert_allclose(got[mgot], ref[mref], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(112, 128), (120, 160), (100, 133)])
def test_plain_matches_jax_xla(shape):
    img = _image(shape)
    ref = np.asarray(jax_detect(jnp.asarray(img), threshold=0.05, use_harris=True))
    got = fast.detect_corners(torch.from_numpy(img), threshold=0.05).numpy()
    _assert_same_corners(ref, got)


def test_plain_matches_pallas_interpret():
    from rgbdslam_v2_tpu.ops.pallas_detect import detect_corners_pallas

    img = _image((112, 128), seed=1)
    ref = np.asarray(detect_corners_pallas(jnp.asarray(img), threshold=0.05, interpret=True))
    got = fast.detect_corners(torch.from_numpy(img), threshold=0.05).numpy()
    _assert_same_corners(ref, got)


def test_wrapper_uses_plain_version_only_for_cpu_tensors():
    img = torch.from_numpy(_image((96, 128), seed=2))
    before = detect.LAUNCHES
    out = detect.detect_pyramid([img], 0.05)[0]
    assert detect.LAUNCHES == before  # the plain version counts no launch
    torch.testing.assert_close(out, fast.detect_corners(img, 0.05))
    with pytest.raises(ValueError):
        detect.detect_pyramid_cuda([img], 0.05)  # a CPU tensor never reaches the kernel


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        backend.resolve_device("cuda")


def test_failed_build_and_launch_raise(tmp_path, monkeypatch):
    """A failing nvcc raises with the compiler's output and leaves no
    library behind; a nonzero launch status raises."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'broken.cu(1): error: expected a \";\"' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("int x\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(backend, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error: expected a"):
        backend.build_kernel_library("broken")
    assert not list((tmp_path / "build").glob("*"))
    with pytest.raises(RuntimeError, match="error code 700"):
        backend.check_launch(700, "detect_pyramid_f32")

