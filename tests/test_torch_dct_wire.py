"""Port parity: the ydct wire (ops/dct_wire.py and the ydct branch of
graph/ingest.py) against the JAX package's ops/dct_wire.py and its numpy
compact_frame path. Spec tables, wire lengths, encoder bytes, both
decoders and the whole-frame unpack are held bitwise, at every named
quality. The JAX module keeps its quality in a process global; each test
sets it and puts back what it found."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from rgbdslam_v2_tpu.graph import manager as jm  # noqa: E402
from rgbdslam_v2_tpu.io import native_loader  # noqa: E402
from rgbdslam_v2_tpu.ops import dct_wire as jdw  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import ingest as ti  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import dct_wire as tdw  # noqa: E402

torch.set_num_threads(1)
QUALITIES = ["2.3", "2.7", "3.1"]
H, W, STRIDE = 96, 128, 2


@pytest.fixture
def jax_quality():
    """Set the JAX package's global quality; restore it afterwards."""
    found = jdw.QUALITY
    yield jdw.set_quality
    jdw.set_quality(found)


def _gray(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (96 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0) + 40 * ((xx // 20 + yy // 20) % 2)
           + rng.normal(0, 3.0, (h, w)))
    return np.clip(img, 0, 255).astype(np.uint8)


def _frame(seed):
    rng = np.random.default_rng(seed)
    g = _gray(seed).astype(np.int32)
    rgb = np.clip(g[..., None] + rng.integers(-40, 40, (H, W, 3)), 0, 255).astype(np.uint8)
    depth = np.round(rng.uniform(0.3, 9.0, (H, W)) * 5000).astype(np.uint16)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0
    return rgb, depth


@pytest.mark.parametrize("q", QUALITIES)
def test_spec_tables_and_lengths_match_jax(q, jax_quality):
    jax_quality(q)
    sp = tdw.spec(q)
    np.testing.assert_array_equal(tdw.DCT8, jdw.DCT8)
    np.testing.assert_array_equal(tdw.ZIGZAG, jdw.ZIGZAG)
    np.testing.assert_array_equal(sp.bit_alloc, jdw.BIT_ALLOC)
    np.testing.assert_array_equal(sp.qstep, jdw.QSTEP)
    np.testing.assert_array_equal(sp.synthesis, jdw.SYNTHESIS)
    assert sp.bits_per_block == jdw.BITS_PER_BLOCK
    for h, w in [(120, 160), (480, 640), (H, W)]:
        assert tdw.dct_luma_len(h, w, sp) == jdw.dct_luma_len(h, w)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_bytes_and_decoders_match_jax(q, seed, jax_quality):
    jax_quality(q)
    sp = tdw.spec(q)
    img = _gray(seed, 120, 160)
    wire = tdw.encode_luma_dct(img, sp)
    np.testing.assert_array_equal(wire, jdw.encode_luma_dct(img))
    ref_np = jdw.decode_luma_dct_np(wire, 120, 160)
    np.testing.assert_array_equal(tdw.decode_luma_dct_np(wire, 120, 160, sp), ref_np)
    ref_dev = np.asarray(jdw.decode_luma_dct_dev(jnp.asarray(wire), 120, 160))
    got = tdw.decode_luma_dct_dev(torch.from_numpy(wire), 120, 160, sp)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref_dev)
    np.testing.assert_array_equal(got.numpy(), ref_np)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("depth_bits", [10, 12])
def test_compact_frame_ydct_and_unpack_match_jax(q, depth_bits, jax_quality, monkeypatch):
    jax_quality(q)
    sp = tdw.spec(q)
    rgb, depth = _frame(depth_bits)
    # the port's numpy encoder (compact_frame's plain version; its native
    # encoder is held to it in test_torch_native_compact.py) against the JAX
    # package's numpy path: its ydct luma of the same Y plane and its yc12
    # depth/chroma tail (the tail is shared by both formats)
    got = ti.compact_frame_numpy(rgb, depth, STRIDE, depth_bits, sp)
    r16 = rgb.astype(np.uint16)
    gray8 = ((r16[..., 0] * 77 + r16[..., 1] * 150 + r16[..., 2] * 29) >> 8).astype(np.uint8)
    tail = np.asarray(jm.compact_frame(rgb, depth, STRIDE, fmt="yc12", gray_bits=8,
                                       depth_bits=depth_bits))[H * W:]
    ref = np.concatenate([jdw.encode_luma_dct(gray8), tail])
    np.testing.assert_array_equal(got, ref)
    # a grey input goes through the JAX package's whole numpy ydct branch
    monkeypatch.setattr(native_loader, "compact_ydct", lambda *a, **k: None)
    np.testing.assert_array_equal(
        ti.compact_frame_numpy(gray8, depth, STRIDE, depth_bits, sp),
        np.asarray(jm.compact_frame(gray8, depth, STRIDE, fmt="ydct", depth_bits=depth_bits)))

    g_j, d_j, c_j = jm._unpack_yc12(jnp.asarray(ref), H, W, STRIDE, "dct", depth_bits)
    g_t, d_t, c_t = ti.unpack_yc12(torch.from_numpy(got), H, W, STRIDE, depth_bits, sp)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(d_t.numpy().view(np.uint32), np.asarray(d_j).view(np.uint32))


def test_unknown_quality_and_odd_frames_raise():
    with pytest.raises(ValueError, match="tpu_dct_quality"):
        tdw.spec("2.5")
    rgb, depth = _frame(3)
    with pytest.raises(ValueError, match="divisible by 8"):
        ti.compact_frame(rgb[:92], depth[:92], STRIDE, 10, tdw.spec("2.7"))
