"""ctypes bridge to the native wire encoder ``native/compact_ingest.cpp``.

Port of the compact half of ``rgbdslam_v2_tpu/io/native_loader.py``
(``_ensure_built`` restricted to the ``compact_*`` entries,
``compact_yc12`` with 8-, 6- and 5-bit luma, ``compact_ydct``, and
``delta_encode_native`` as ``compact_delta``). The C source is the JAX package's,
unedited, built alone (it needs no libpng) by ``backend``: ``g++ -O3
-ffp-contract=off -shared -fPIC`` into the git-ignored ``_build/``, at first
use. A failed build raises; only an input layout the C code refuses (float
or odd-shaped RGB, a frame it cannot tile) returns None, and the caller then
encodes with numpy.

* yc12 and delta bytes equal the numpy encoder's
  (``graph/ingest.compact_frame_numpy``, ``delta_encode_numpy``).
* ydct is near-exact: the C DCT accumulates in double, so a code may
  differ by 1 from the numpy float32 GEMM encode, at ~2e-3 of positions on
  the bench frames (2.05e-3): mostly DC codes on an exact .5 tie, which
  round either way. A code off by 1 moves the decoded pixels by up to its
  step (3-4 grey levels at quality 2.7); each wire decodes the same on the
  card and in numpy. The coded spec
  is the caller's ``DctSpec`` (bits and step of its K coded positions and
  the zigzag order of those positions), never a default one.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .. import backend
from ..ops.dct_wire import ZIGZAG, DctSpec

LIBRARY = "compact_ingest"
_ready = set()
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The encoder library, built at first use; raises when it cannot be
    built or loaded."""
    lib = backend.load_kernel_library(LIBRARY)
    with _lock:
        if id(lib) not in _ready:
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.compact_yc12.restype = i
            lib.compact_yc12.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
            lib.compact_ydct.restype = i
            lib.compact_ydct.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp, vp, vp, i, vp]
            lib.compact_delta.restype = i
            lib.compact_delta.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
            _ready.add(id(lib))
    return lib


def _inputs(rgb, depth):
    """Contiguous inputs and the four pointers (rgb, gray, d16, meters) the
    C entries take, exactly one of each pair set; None when the layout is
    not one the C code reads (u8 RGB or gray, u16 counts or f32 meters)."""
    rgb = np.asarray(rgb)
    depth = np.asarray(depth)
    if depth.ndim != 2:
        return None
    H, W = depth.shape
    if rgb.dtype != np.uint8 or rgb.shape not in ((H, W, 3), (H, W)):
        return None
    if depth.dtype not in (np.uint16, np.float32):
        return None
    keep = [np.ascontiguousarray(rgb), np.ascontiguousarray(depth)]
    ptr = [a.ctypes.data_as(ctypes.c_void_p) for a in keep]
    luma = (ptr[0], None) if rgb.ndim == 3 else (None, ptr[0])
    dep = (ptr[1], None) if depth.dtype == np.uint16 else (None, ptr[1])
    return keep, (*luma, *dep), H, W


def compact_yc12(rgb, depth, stride: int, depth_bits: int, chroma_mult: int,
                 gray_bits: int = 8) -> Optional[np.ndarray]:
    """The yc12 wire of one frame (numpy ``compact_frame``'s bytes), or
    None when the C code refuses the layout."""
    lib = library()
    got = _inputs(rgb, depth)
    if got is None:
        return None
    keep, ptrs, H, W = got
    out = np.empty(H * W * 4, np.uint8)
    n = lib.compact_yc12(*ptrs, H, W, int(stride), int(gray_bits), int(depth_bits),
                         int(chroma_mult), out.ctypes.data_as(ctypes.c_void_p))
    return out[:n] if n > 0 else None


def compact_ydct(rgb, depth, stride: int, depth_bits: int, chroma_mult: int,
                 spec: DctSpec) -> Optional[np.ndarray]:
    """The ydct wire of one frame at `spec`'s rate/quality point, or None
    when the C code refuses the layout (H or W not divisible by 8)."""
    lib = library()
    got = _inputs(rgb, depth)
    if got is None:
        return None
    keep, ptrs, H, W = got
    if H % 8 or W % 8:
        return None
    bit_alloc = np.ascontiguousarray(spec.bit_alloc, np.int32)
    qstep = np.ascontiguousarray(spec.qstep, np.float32)
    zigzag = np.ascontiguousarray(ZIGZAG[: spec.k_coded], np.int32)
    out = np.empty(H * W * 4, np.uint8)
    n = lib.compact_ydct(*ptrs, H, W, int(stride), int(depth_bits), int(chroma_mult),
                         bit_alloc.ctypes.data_as(ctypes.c_void_p),
                         qstep.ctypes.data_as(ctypes.c_void_p),
                         zigzag.ctypes.data_as(ctypes.c_void_p), spec.k_coded,
                         out.ctypes.data_as(ctypes.c_void_p))
    return out[:n] if n > 0 else None


def compact_delta(rgb, depth, prev_qg: np.ndarray, prev_qd: np.ndarray, stride: int,
                  max_clamp: float):
    """The temporal-delta (P) wire against the state mirror (prev_qg (H, W)
    u8, prev_qd (h, w) u16), which it advances IN PLACE: (packed, prev_qg,
    prev_qd); "clamped" where more than max_clamp of the residuals clamp
    (the mirror is then partly advanced: the caller ships an I wire and
    rebuilds it); None where the C code refuses the layout."""
    lib = library()
    got = _inputs(rgb, depth)
    if got is None or prev_qg.dtype != np.uint8 or prev_qd.dtype != np.uint16:
        return None
    if not (prev_qg.flags.c_contiguous and prev_qd.flags.c_contiguous):
        return None
    keep, ptrs, H, W = got
    h, w = H // stride, W // stride
    cm = 4 if (H % (4 * stride) == 0 and W % (4 * stride) == 0) else 2
    cs = cm * stride
    out = np.empty(H * W // 2 + (h * w // 8) * 5 + 2 * (H // cs) * (W // cs), np.uint8)
    n = lib.compact_delta(*ptrs, prev_qg.ctypes.data_as(ctypes.c_void_p),
                          prev_qd.ctypes.data_as(ctypes.c_void_p), H, W, int(stride), cm,
                          int(max_clamp * (H * W + h * w)), out.ctypes.data_as(ctypes.c_void_p))
    if n == -2:
        return "clamped"
    return (out[:n], prev_qg, prev_qd) if n > 0 else None
