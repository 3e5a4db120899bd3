"""A PNG codec of the port's own: the TUM images without cv2, PIL or libpng.

No JAX counterpart: the JAX package reads TUM PNGs with ``cv2.imread``
(``io/tum.py``) or libpng (``native/rgbd_loader.cpp``), neither of which
the card's machine has. This module needs only the standard library's
``zlib`` and numpy, plus the row unfilter in ``csrc/png_unfilter.cpp``.

* Reader (:func:`decode_png`, :func:`read_png`): :func:`inflate_png`
  checks the signature, walks the chunks checking each CRC
  (``zlib.crc32``), joins the IDAT chunks and inflates them (``zlib``,
  which releases the GIL); then the five row filters (None, Sub, Up,
  Average, Paeth) are undone. Colour type 2 (RGB)
  and 0 (grey) at 8 and 16 bits; 16-bit samples are big-endian in the file
  and come back as native ``uint16``. Interlacing, palettes, alpha and
  other bit depths raise ``ValueError``. TUM's rgb PNGs are 8-bit RGB and
  its depth PNGs 16-bit grey.
* The unfilter runs on the host, in C++ (:func:`unfilter_native`): each
  reconstructed byte depends on the bytes already reconstructed to its
  left and above, so within an image the work is a sequential recurrence,
  as inflate is. The build is ``backend``'s (``g++ -O3 -shared -fPIC`` into
  ``_build/``, at first use) and a failed build raises.
  :func:`unfilter_numpy` is the plain version the tests hold it to, on
  what :func:`inflate_png` returns.
* Writer (:func:`encode_png`, :func:`write_png`): 8-bit RGB or 16-bit
  grey, every row with the Up filter (one vectorised subtraction), deflated
  at ``PNG_LEVEL``. The bytes differ from ``cv2.imwrite``'s; the pixels
  decode equal.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .. import backend

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# deflate level of the writer: 1, the fastest, since TUM-like frames
# (sensor noise, textures) barely compress at any level
PNG_LEVEL = 1
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)
LIBRARY = "png_unfilter"
# (colour type, bit depth) -> samples a pixel
_LAYOUTS = {(2, 8): 3, (2, 16): 3, (0, 8): 1, (0, 16): 1}
_ready = set()
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The unfilter library, built at first use; raises when it cannot be
    built or loaded."""
    lib = backend.load_kernel_library(LIBRARY)
    with _lock:
        if id(lib) not in _ready:
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int]
            _ready.add(id(lib))
    return lib


# ---------------------------------------------------------------------------
# row filters
def _check_filtered(filtered, rows: int, row_bytes: int) -> np.ndarray:
    f = np.ascontiguousarray(np.frombuffer(filtered, np.uint8) if isinstance(
        filtered, (bytes, bytearray, memoryview)) else filtered, dtype=np.uint8).reshape(-1)
    if f.size != rows * (row_bytes + 1):
        raise ValueError(f"filtered data holds {f.size} bytes, expected {rows} rows of "
                         f"1 + {row_bytes}")
    return f


def unfilter_native(filtered, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the row filters in C++: rows x (1 + row_bytes) filtered bytes ->
    (rows, row_bytes) u8."""
    f = _check_filtered(filtered, rows, row_bytes)
    out = np.empty((rows, row_bytes), np.uint8)
    bad = library().png_unfilter(f.ctypes.data, out.ctypes.data, rows, row_bytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: filter type {f[(bad - 1) * (row_bytes + 1)]} "
                         "is not 0-4")
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_numpy(filtered, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The plain version of unfilter_native: None, Sub and Up vectorised over
    the row (Sub as a wrapping cumulative sum a byte phase), Average and
    Paeth byte by byte."""
    f = _check_filtered(filtered, rows, row_bytes).reshape(rows, row_bytes + 1)
    out = np.zeros((rows, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for r in range(rows):
        t, row = int(f[r, 0]), f[r, 1:]
        if t == FILTER_NONE:
            out[r] = row
        elif t == FILTER_SUB:
            n = -(-row_bytes // bpp) * bpp
            padded = np.zeros(n, np.uint8)
            padded[:row_bytes] = row
            out[r] = np.cumsum(padded.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[
                :row_bytes]
        elif t == FILTER_UP:
            out[r] = row + prior
        elif t in (FILTER_AVERAGE, FILTER_PAETH):
            cur = [0] * row_bytes
            up = prior.tolist()
            raw = row.tolist()
            for x in range(row_bytes):
                a = cur[x - bpp] if x >= bpp else 0
                if t == FILTER_AVERAGE:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (raw[x] + pred) & 0xFF
            out[r] = cur
        else:
            raise ValueError(f"PNG row {r}: filter type {t} is not 0-4")
        prior = out[r]
    return out


def filter_rows(raw: np.ndarray, bpp: int, types) -> bytes:
    """Filter (rows, row_bytes) u8 with one filter type a row (an int for
    all rows, or a sequence) -> the rows x (1 + row_bytes) bytes a PNG
    holds. Vectorised: filtering reads only raw bytes."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    rows, row_bytes = raw.shape
    types = np.broadcast_to(np.asarray(types, np.uint8), (rows,))
    out = np.empty((rows, row_bytes + 1), np.uint8)
    out[:, 0] = types
    if (types == FILTER_UP).all():  # the writer's filter: one wrapping subtraction
        out[0, 1:] = raw[0]
        np.subtract(raw[1:], raw[:-1], out=out[1:, 1:])
        return out.tobytes()
    cur = raw.astype(np.int16)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = up[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) >> 1, paeth])
    t = types.astype(np.int64)
    if (t > FILTER_PAETH).any():
        raise ValueError("filter types are 0-4")
    pred = preds[t, np.arange(rows)]
    out[:, 1:] = (cur - pred).astype(np.uint8)
    return out.tobytes()


# ---------------------------------------------------------------------------
# chunks
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _chunks(data):
    """(type, payload memoryview) of each chunk after the signature, CRCs
    checked; the payloads are views of `data`, not copies."""
    data = memoryview(data)
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack_from(">I", data, end)
        if zlib.crc32(payload, zlib.crc32(kind)) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG file has no IEND chunk")


def _check_header(payload) -> tuple:
    """The IHDR fields, or ValueError for a layout this reader refuses."""
    if len(payload) != 13:
        raise ValueError("bad IHDR length")
    header = struct.unpack(">IIBBBBB", payload)
    _, _, depth, ctype, compression, method, interlace = header
    if ctype == 3:
        raise ValueError("palette PNGs are not supported")
    if ctype in (4, 6):
        raise ValueError("PNGs with alpha are not supported")
    if (ctype, depth) not in _LAYOUTS:
        raise ValueError(f"unsupported PNG colour type {ctype} at {depth} bits")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if compression or method:
        raise ValueError(f"unknown PNG compression {compression} or filter method {method}")
    return header


class Inflated(NamedTuple):
    """A PNG's layout and its inflated, still filtered rows."""

    height: int
    width: int
    depth: int  # bits a sample
    samples: int  # samples a pixel
    filtered: bytes  # height x (1 + row_bytes)

    @property
    def bpp(self) -> int:
        """Bytes a pixel: the filters' distance to the left neighbour."""
        return self.samples * self.depth // 8

    @property
    def row_bytes(self) -> int:
        return self.width * self.bpp

    def image(self, raw: np.ndarray) -> np.ndarray:
        """The unfiltered (height, row_bytes) u8 as (H, W, 3) RGB or (H, W)
        grey, u8 or native u16."""
        shape = ((self.height, self.width, self.samples) if self.samples > 1
                 else (self.height, self.width))
        if self.depth == 16:
            return raw.view(">u2").astype(np.uint16).reshape(shape)
        return raw.reshape(shape)


def inflate_png(data) -> Inflated:
    """PNG bytes (or any buffer) -> its layout and inflated filtered rows;
    chunks and CRCs checked, the layouts this reader refuses raise."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if header is None:
            if kind != b"IHDR":
                raise ValueError("PNG file does not start with an IHDR chunk")
            header = _check_header(payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE" and header[3] == 2:
            continue  # a suggested palette of a truecolour image: not needed
        elif kind[0] & 0x20 == 0 and kind != b"IEND":  # critical and unknown
            raise ValueError(f"unexpected critical PNG chunk {kind!r}")
    width, height, depth, ctype = header[:4]
    if not idat:
        raise ValueError("PNG file has no IDAT chunk")
    try:
        filtered = zlib.decompress(idat[0] if len(idat) == 1 else b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    return Inflated(height, width, depth, _LAYOUTS[(ctype, depth)], filtered)


def decode_png(data) -> np.ndarray:
    """PNG bytes (or any buffer) -> (H, W, 3) RGB or (H, W) grey, u8 or
    native u16."""
    inf = inflate_png(data)
    return inf.image(unfilter_native(inf.filtered, inf.height, inf.row_bytes, inf.bpp))


def read_png(path) -> np.ndarray:
    """Decode a PNG file (decode_png); FileNotFoundError where there is none."""
    return decode_png(Path(path).read_bytes())


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> 8-bit RGB, or (H, W) u16 -> 16-bit grey PNG bytes;
    every row Up-filtered, deflated at PNG_LEVEL."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, bpp = 2, 8, 3
        raw = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, bpp = 0, 16, 2
        raw = np.ascontiguousarray(img.astype(">u2")).view(np.uint8).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"write 8-bit RGB (H, W, 3) u8 or 16-bit grey (H, W) u16, not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    body = zlib.compress(filter_rows(raw, bpp, FILTER_UP), PNG_LEVEL)
    return SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", body) + _chunk(b"IEND", b"")


def write_png(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))
