"""The port's native wire encoder (rgbdslam_v2_tpu_torch/io/native_compact.py
over native/compact_ingest.cpp, built by the port) against its numpy
encoder and the JAX package's numpy path.

* yc12: native bytes equal the port's numpy bytes and the JAX package's
  compact_frame forced onto numpy (no native encoder, no cv2, as
  tests/test_native_compact.py forces it), for 10/12-bit depth, u16/f32
  depth, RGB and grey luma.
* ydct at quality 2.7: equal wire length and depth/chroma tails; luma
  codes within +-1 of the numpy codes at under 0.5% of the (block,
  position) codes, the bound of the JAX package's own near-exact test
  (tests/test_dct_wire.py::test_native_encoder_near_exact): the C DCT
  accumulates in double, so a DC code on an exact .5 tie (a block sum of
  4 mod 8) rounds either way; the two wires' decodes differ only as far
  as the differing codes move the pixels (a code off by 1 at a step of 16
  moves a pixel by up to 4 grey levels), within 1 for the rounding.
* A layout the C code refuses goes to numpy and is counted; a build that
  fails raises.

It also holds ``jax_native_encoder``, the module fixture every port test
file that compares against the JAX ``compact_frame`` or ``GraphManager``
imports: the JAX package builds ``native/librgbd_loader.so`` in place at
first use, unlocked, in every xdist worker that collects its native tests,
and keeps a failure (a worker loading the file while another's linker
writes it: "file too short") for good, encoding through cv2's rounding from
then on. The fixture loads the library under a file lock, retrying after
such a failure, and fails the test if it never loads."""
import fcntl
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")
from rgbdslam_v2_tpu.graph import manager as jmanager  # noqa: E402
from rgbdslam_v2_tpu.io import native_loader  # noqa: E402

from rgbdslam_v2_tpu_torch import backend  # noqa: E402
from rgbdslam_v2_tpu_torch.graph import ingest  # noqa: E402
from rgbdslam_v2_tpu_torch.io import native_compact  # noqa: E402
from rgbdslam_v2_tpu_torch.ops import dct_wire  # noqa: E402

H, W = 120, 160


def require_jax_native(attempts: int = 3) -> None:
    """Load the JAX package's native library in this process, or raise.

    Under an exclusive lock beside the library: forget a failure kept from
    an unlocked concurrent build and load again; after a second failure
    remove the file, so the next attempt builds it anew."""
    if native_loader._lib is not None:
        return
    lock = native_loader._LIB.with_suffix(".lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        for attempt in range(attempts):
            native_loader._build_error = None
            if native_loader._ensure_built() is not None:
                return
            if attempt >= 1:
                native_loader._LIB.unlink(missing_ok=True)
            time.sleep(0.5)
    raise RuntimeError(f"the JAX package's native library did not load: "
                       f"{native_loader._build_error}")


@pytest.fixture(autouse=True, scope="module")
def jax_native_encoder():
    """The JAX package encodes through its native library in this module
    (its numpy route rounds grey through cv2 where cv2 is installed)."""
    require_jax_native()


def _frame(rng, depth_kind, luma="rgb"):
    rgb = (rng.integers(0, 256, (H, W, 3), np.uint8) if luma == "rgb"
           else rng.integers(0, 256, (H, W), np.uint8))
    if depth_kind == "u16":
        depth = rng.integers(0, 40000, (H, W)).astype(np.uint16)
    else:
        depth = rng.uniform(0.0, 8.0, (H, W)).astype(np.float32)
        depth[0, :6] = [np.nan, np.inf, -np.inf, -1.0, 0.0, 20.0]
    return rgb, depth


def _jax_numpy(monkeypatch, rgb, depth, depth_bits):
    """The JAX package's compact_frame forced onto its numpy path."""
    monkeypatch.setattr(native_loader, "compact_yc12", lambda *a: None)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    return jmanager.compact_frame(rgb, depth, 2, fmt="yc12", gray_bits=8, depth_bits=depth_bits)


@pytest.mark.parametrize("luma", ["rgb", "gray"])
@pytest.mark.parametrize("depth_bits", [10, 12])
@pytest.mark.parametrize("depth_kind", ["u16", "f32"])
def test_native_yc12_bytes_equal_numpy(monkeypatch, luma, depth_bits, depth_kind):
    rgb, depth = _frame(np.random.default_rng(7), depth_kind, luma)
    ingest.reset_encodes()
    native = ingest.compact_frame(rgb, depth, 2, depth_bits)
    assert ingest.ENCODES == {"native": 1, "numpy": 0}
    np.testing.assert_array_equal(native, ingest.compact_frame_numpy(rgb, depth, 2, depth_bits))
    np.testing.assert_array_equal(native, _jax_numpy(monkeypatch, rgb, depth, depth_bits))


def _codes(packed, sp):
    return dct_wire.luma_codes_np(packed, H, W, sp)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_ydct_near_exact(seed):
    sp = dct_wire.spec("2.7")
    rgb, depth = _frame(np.random.default_rng(seed), "u16")
    ingest.reset_encodes()
    native = ingest.compact_frame(rgb, depth, 2, 10, sp)
    assert ingest.ENCODES == {"native": 1, "numpy": 0}
    ref = ingest.compact_frame_numpy(rgb, depth, 2, 10, sp)
    assert native.shape == ref.shape
    nl = dct_wire.dct_luma_len(H, W, sp)
    np.testing.assert_array_equal(native[nl:], ref[nl:])  # depth and chroma: bitwise
    cn, cr = _codes(native[:nl], sp), _codes(ref[:nl], sp)
    assert np.abs(cn - cr).max() <= 1  # codes within +-1
    assert (cn != cr).mean() < 0.005, (cn != cr).mean()  # the JAX test's bound
    dn = dct_wire.decode_luma_dct_np(native[:nl], H, W, sp).astype(int)
    dr = dct_wire.decode_luma_dct_np(ref[:nl], H, W, sp).astype(int)
    # the decodes differ only as far as the differing codes move the pixels
    # (the decoder is linear in the codes), plus 1 for the rounding
    bound = np.abs(dct_wire.code_delta_np(cn, cr, H, W, sp)) + 1.0
    assert (np.abs(dn - dr) <= bound).all()
    assert np.array_equal(dn[bound == 1.0], dr[bound == 1.0])  # equal codes: equal pixels


def test_native_ydct_takes_the_callers_spec():
    """Each quality point's spec reaches the C encoder: the wire length is
    the spec's, and the codes decode near the numpy encoder's."""
    rgb, depth = _frame(np.random.default_rng(3), "u16")
    for name in dct_wire.SPECS:
        sp = dct_wire.spec(name)
        native = ingest.compact_frame(rgb, depth, 2, 12, sp)
        ref = ingest.compact_frame_numpy(rgb, depth, 2, 12, sp)
        assert native.shape == ref.shape
        nl = dct_wire.dct_luma_len(H, W, sp)
        assert np.abs(_codes(native[:nl], sp) - _codes(ref[:nl], sp)).max() <= 1


def test_refused_layout_goes_to_numpy_and_is_counted():
    rng = np.random.default_rng(4)
    rgb, depth = _frame(rng, "u16")
    rgb_f = rgb.astype(np.float32) / 255.0  # float RGB: the C code reads u8 only
    depth_f64 = depth.astype(np.float64) / 5000.0  # float64 depth: f32 or u16 only
    ingest.reset_encodes()
    for args in ((rgb_f, depth), (rgb, depth_f64)):
        assert native_compact.compact_yc12(*args, 2, 10, 4) is None
        got = ingest.compact_frame(*args, 2, 10)
        np.testing.assert_array_equal(got, ingest.compact_frame_numpy(*args, 2, 10))
    assert ingest.ENCODES == {"native": 0, "numpy": 2}


def _fresh_build(monkeypatch, tmp_path, command):
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(backend, "_libs", {})
    monkeypatch.setattr(backend, "host_compiler", lambda: command)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path, [str(tmp_path / "no" / "g++"), *backend.HOST_FLAGS])
    rgb, depth = _frame(np.random.default_rng(5), "u16")
    with pytest.raises(RuntimeError, match="cannot start the compiler"):
        ingest.compact_frame(rgb, depth, 2, 10)  # never a silent numpy encode


def test_failing_build_raises_with_its_output(monkeypatch, tmp_path):
    cxx = tmp_path / "bin" / "g++"
    cxx.parent.mkdir()
    cxx.write_text("#!/bin/sh\necho 'compact_ingest.cpp:1: error: broken' >&2\nexit 1\n")
    cxx.chmod(0o755)
    _fresh_build(monkeypatch, tmp_path, [str(cxx), *backend.HOST_FLAGS])
    with pytest.raises(RuntimeError, match="error: broken"):
        native_compact.library()
    assert not list((tmp_path / "build").glob("*"))


def test_build_is_keyed_and_git_ignored():
    """The library lands in the port's _build/, keyed by the source, the
    compiler and its flags, never beside the JAX package's own build in
    native/."""
    path = backend.library_path("compact_ingest")
    assert path.parent == backend.BUILD_DIR and path.name.startswith("libcompact_ingest-")
    native_compact.library()
    assert path.exists()
    assert backend.library_path("compact_ingest", ["clang++", *backend.HOST_FLAGS]) != path


def test_a_kept_build_failure_is_retried(monkeypatch):
    """A failure the JAX loader kept from a build raced by another worker
    (the file read while a linker wrote it) does not stick: the fixture's
    helper forgets it under the lock and loads the library."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_error",
                        f"{native_loader._LIB}: file too short")
    assert not native_loader.native_available()  # the loader alone keeps it
    require_jax_native()
    assert native_loader.native_available() and native_loader._build_error is None
