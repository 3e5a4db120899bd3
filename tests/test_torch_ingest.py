"""Port parity: the yc12 ingest wire. Host bytes from the port's encoder equal
the JAX package's compact_frame; the device unpack (gray8, depth, color)
is bit-exact against the JAX unpack."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.graph import manager as jm  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import ingest as ti  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

torch.set_num_threads(1)
H, W, STRIDE = 96, 128, 2


def _frame(seed, depth_kind):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.3, 9.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    if depth_kind == "u16":
        return rgb, np.round(depth * 5000).astype(np.uint16)
    return rgb, depth


@pytest.mark.parametrize("depth_bits", [10, 12])
@pytest.mark.parametrize("depth_kind", ["u16", "f32"])
def test_compact_frame_bytes_and_unpack_match_jax(depth_bits, depth_kind):
    rgb, depth = _frame(depth_bits, depth_kind)
    ref = np.asarray(jm.compact_frame(rgb, depth, STRIDE, fmt="yc12", gray_bits=8,
                                      depth_bits=depth_bits))
    got = ti.compact_frame(rgb, depth, STRIDE, depth_bits)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)

    g_j, d_j, c_j = jm._unpack_yc12(jnp.asarray(ref), H, W, STRIDE, 8, depth_bits)
    g_t, d_t, c_t = ti.unpack_yc12(torch.from_numpy(got), H, W, STRIDE, depth_bits)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert d_t.dtype == torch.float32
    np.testing.assert_array_equal(d_t.numpy().view(np.uint32),
                                  np.asarray(d_j).view(np.uint32))


def test_gray_input_matches_jax():
    rgb, depth = _frame(7, "u16")
    gray = rgb[..., 1].copy()
    ref = np.asarray(jm.compact_frame(gray, depth, STRIDE, fmt="yc12", gray_bits=8,
                                      depth_bits=12))
    np.testing.assert_array_equal(ti.compact_frame(gray, depth, STRIDE, 12), ref)
