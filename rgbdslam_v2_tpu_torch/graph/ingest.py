"""The ingest wires: host packing and device unpacking.

Port of the wire parts of ``rgbdslam_v2_tpu/graph/manager.py``:

* host side: ``maybe_scale_depth``, ``compact_frame`` (yc12 with 8-, 6- or
  5-bit luma, ydct, raw), through the native C encoder
  (``io/native_compact.py``) as the JAX package does, with the numpy
  encoder as the plain version and the fallback for layouts the C code
  refuses: ``compact_frame_numpy``, ``_d10_lut``/``_pack10``,
  ``_d12_lut``/``_pack12``, ``_dither6``, ``_pack6``, ``_pack5_codes``/
  ``_pack5``, ``_pack4``, ``_chroma_mult``; the temporal-delta (P-frame)
  encoder ``delta_encode`` and its state mirror ``host_unpack_codes``;
  ``wire_intra_len`` and ``wire_delta_len``;
* device side, torch: ``unpack_yc12`` (8-, 6- and 5-bit and DCT luma),
  ``unpack_raw``, ``unpack_yc12_delta``, ``_decode_color_small`` and
  ``finish_yc12`` (depth masking, feature-depth plane, extraction);
  ``prepare_and_extract`` and, for the delta wire, ``prepare_and_extract_wire``.

Wire layout: [luma | sqrt-coded depth at stride s (10 or 12 bits) | Cb | Cr
at stride cm*s]. The luma is H*W u8 bytes (8 bits), Bayer-dithered 6- or
5-bit codes packed 4 px in 3 B or 8 px in 5 B, or the fixed-rate block-DCT
planes of ``ops/dct_wire.py`` (ydct, chosen by passing its ``DctSpec``). The
raw wire is [gray u8 | depth u16 at full resolution | colour at stride s].
A delta (P) wire is [4-bit luma-code residuals | 5-bit depth-code residuals
| Cb | Cr] against the previous frame's reconstructed 6/10-bit codes.
Native yc12 and delta bytes equal the numpy bytes; native ydct codes may
differ from the numpy codes by 1 at ~2e-3 of positions, mostly DC codes on
an exact .5 tie (``io/native_compact.py``).
``ENCODES`` counts host encodes by route. The JAX uint32 shifts are int32
ops here.
"""
from __future__ import annotations

import functools
import threading
from typing import Optional

import numpy as np
import torch

from ..io import native_compact
from ..models.orb import feature_depth_map
from ..ops.dct_wire import DctSpec, check_shape, dct_luma_len, decode_luma_dct_dev, encode_luma_dct

DEPTH_SCALE = 5000.0  # TUM PNG quantization: depth_meters = png_u16 / 5000
# host encodes by route since the last reset_encodes(): the native C
# encoder, or numpy (layouts the C code refuses)
ENCODES = {"native": 0, "numpy": 0}
_encodes_lock = threading.Lock()


def reset_encodes() -> None:
    with _encodes_lock:
        for k in ENCODES:
            ENCODES[k] = 0


def _count(route: str) -> None:
    with _encodes_lock:
        ENCODES[route] += 1


@functools.lru_cache(maxsize=None)
def _d12_lut() -> np.ndarray:
    """u16 depth -> 12-bit sqrt code q = round(sqrt(256 d16))."""
    d = np.arange(65536, dtype=np.float64)
    return np.clip(np.round(np.sqrt(d * 256.0)), 0, 4095).astype(np.uint16)


@functools.lru_cache(maxsize=None)
def _d10_lut() -> np.ndarray:
    """u16 depth -> 10-bit sqrt code q = round(sqrt(16 d16))."""
    d = np.arange(65536, dtype=np.float64)
    return np.clip(np.round(np.sqrt(d * 16.0)), 0, 1023).astype(np.uint16)


def _pack12(q: np.ndarray) -> np.ndarray:
    a = q.reshape(-1, 2)
    lo = a[:, 0].astype(np.uint32)
    hi = a[:, 1].astype(np.uint32)
    out = np.empty((a.shape[0], 3), np.uint8)
    out[:, 0] = lo & 0xFF
    out[:, 1] = ((lo >> 8) & 0x0F) | ((hi & 0x0F) << 4)
    out[:, 2] = hi >> 4
    return out.reshape(-1)


def _pack10(q: np.ndarray) -> np.ndarray:
    a = q.reshape(-1, 4).astype(np.uint32)
    out = np.empty((a.shape[0], 5), np.uint8)
    out[:, 0] = a[:, 0] & 0xFF
    out[:, 1] = (a[:, 0] >> 8) | ((a[:, 1] & 0x3F) << 2)
    out[:, 2] = (a[:, 1] >> 6) | ((a[:, 2] & 0x0F) << 4)
    out[:, 3] = (a[:, 2] >> 4) | ((a[:, 3] & 0x03) << 6)
    out[:, 4] = a[:, 3] >> 2
    return out.reshape(-1)


def _chroma_mult(H: int, W: int, stride: int) -> int:
    cs = 4 * stride
    return 4 if (H % cs == 0 and W % cs == 0) else 2


def _chroma_plane(H: int, W: int, stride: int) -> int:
    """Samples of one chroma plane (Cb or Cr) at stride cm*s."""
    cs = _chroma_mult(H, W, stride) * stride
    return (H // cs) * (W // cs)


def _pack6(gray8: np.ndarray) -> np.ndarray:
    """(N,) u8 gray, N % 4 == 0 -> (3N/4,) u8: 6-bit luma, 4 px per 3 B."""
    a = (gray8.reshape(-1, 4) >> 2).astype(np.uint8)
    out = np.empty((a.shape[0], 3), np.uint8)
    out[:, 0] = a[:, 0] | ((a[:, 1] & 0x03) << 6)
    out[:, 1] = (a[:, 1] >> 2) | ((a[:, 2] & 0x0F) << 4)
    out[:, 2] = (a[:, 2] >> 4) | (a[:, 3] << 2)
    return out.reshape(-1)


def _pack5_codes(codes: np.ndarray) -> np.ndarray:
    """(N,) u8 values < 32, N % 8 == 0 -> (5N/8,) u8 little-endian bit
    stream (the 5-bit luma and the depth-residual wires)."""
    a = codes.reshape(-1, 8).astype(np.uint8)
    out = np.empty((a.shape[0], 5), np.uint8)
    out[:, 0] = a[:, 0] | ((a[:, 1] & 0x07) << 5)
    out[:, 1] = (a[:, 1] >> 3) | (a[:, 2] << 2) | ((a[:, 3] & 0x01) << 7)
    out[:, 2] = (a[:, 3] >> 1) | ((a[:, 4] & 0x0F) << 4)
    out[:, 3] = (a[:, 4] >> 4) | (a[:, 5] << 1) | ((a[:, 6] & 0x03) << 6)
    out[:, 4] = (a[:, 6] >> 2) | (a[:, 7] << 3)
    return out.reshape(-1)


def _pack5(gray8: np.ndarray) -> np.ndarray:
    """(N,) u8 gray, N % 8 == 0 -> (5N/8,) u8: 5-bit luma, 8 px per 5 B."""
    return _pack5_codes(gray8 >> 3)


def _pack4(codes: np.ndarray) -> np.ndarray:
    """(N,) u8 values < 16, N % 2 == 0 -> (N/2,) u8, low nibble first."""
    a = codes.reshape(-1, 2)
    return (a[:, 0] | (a[:, 1] << 4)).astype(np.uint8)


_BAYER4 = np.array([[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]], np.uint16)


@functools.lru_cache(maxsize=None)
def _dither_plane(H: int, W: int, bits: int) -> np.ndarray:
    return (_BAYER4[np.arange(H)[:, None] % 4, np.arange(W)[None, :] % 4]
            >> (bits - 4)).astype(np.int16)


def _dither6(gray8: np.ndarray, bits: int = 6) -> np.ndarray:
    """Ordered (Bayer 4x4) dither of one quantization step before the
    `bits`-bit truncation; the g >> bits term cancels the decoder's
    bit-replication bias."""
    H, W = gray8.shape
    g = gray8.astype(np.int16)
    return np.clip(g + _dither_plane(H, W, bits) - (g >> bits), 0, 255).astype(np.uint8)


def _gray8(rgb: np.ndarray) -> np.ndarray:
    """u8 luma of an RGB or grey frame (the native encoder's BT.601
    fixed-point formula)."""
    if rgb.ndim == 3:
        r16 = rgb.astype(np.uint16)
        return ((r16[..., 0] * 77 + r16[..., 1] * 150 + r16[..., 2] * 29) >> 8).astype(np.uint8)
    if rgb.dtype == np.uint8:
        return rgb
    scale = 255.0 if rgb.dtype.kind == "f" else 1.0
    return np.clip(rgb * scale, 0, 255).astype(np.uint8)


def _d16(depth: np.ndarray) -> np.ndarray:
    """u16 depth counts of a u16 or metres frame."""
    if depth.dtype == np.uint16:
        return depth
    d = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
    return np.clip(d * DEPTH_SCALE, 0, 65535).astype(np.uint16)


def _chroma(rgb: np.ndarray, H: int, W: int, cs: int) -> np.ndarray:
    """Cb and Cr planes at stride cs (BT.601), 128 for a grey frame."""
    if rgb.ndim == 3:
        sub = rgb[::cs, ::cs].astype(np.float32)
        r, g, b = sub[..., 0], sub[..., 1], sub[..., 2]
        cb = np.clip(128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b, 0, 255).astype(np.uint8)
        cr = np.clip(128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b, 0, 255).astype(np.uint8)
    else:
        cb = np.full((H // cs, W // cs), 128, np.uint8)
        cr = np.full((H // cs, W // cs), 128, np.uint8)
    return np.concatenate([cb.reshape(-1), cr.reshape(-1)])


def wire_intra_len(H: int, W: int, stride: int, gray_bits: int = 6, depth_bits: int = 10) -> int:
    """Byte length of one yc12 (I) wire."""
    n_gray = {8: H * W, 6: (H * W // 4) * 3, 5: (H * W // 8) * 5}[gray_bits]
    h, w = H // stride, W // stride
    n_d = (h * w // 4) * 5 if depth_bits == 10 else (h * w // 2) * 3
    return n_gray + n_d + 2 * _chroma_plane(H, W, stride)


def wire_delta_len(H: int, W: int, stride: int) -> int:
    """Byte length of one temporal-delta (P) wire: 4-bit luma residuals,
    5-bit depth-code residuals and the absolute chroma tail."""
    h, w = H // stride, W // stride
    return H * W // 2 + (h * w // 8) * 5 + 2 * _chroma_plane(H, W, stride)


def host_unpack_codes(packed: np.ndarray, H: int, W: int, stride: int):
    """The 6-bit luma codes (H, W) u8 and 10-bit depth codes (h, w) u16 of
    an I wire: the delta encoder's state mirror, read back off the buffer
    so that it matches the device's reconstruction whatever encoded it."""
    n_gray = (H * W // 4) * 3
    g = packed[:n_gray].reshape(-1, 3).astype(np.uint16)
    qg = np.stack([g[:, 0] & 0x3F, (g[:, 0] >> 6) | ((g[:, 1] & 0x0F) << 2),
                   (g[:, 1] >> 4) | ((g[:, 2] & 0x03) << 4), g[:, 2] >> 2],
                  axis=-1).reshape(H, W).astype(np.uint8)
    h, w = H // stride, W // stride
    b = packed[n_gray : n_gray + (h * w // 4) * 5].reshape(-1, 5).astype(np.uint16)
    qd = np.stack([b[:, 0] | ((b[:, 1] & 0x03) << 8), (b[:, 1] >> 2) | ((b[:, 2] & 0x0F) << 6),
                   (b[:, 2] >> 4) | ((b[:, 3] & 0x3F) << 4), (b[:, 3] >> 6) | (b[:, 4] << 2)],
                  axis=-1).reshape(h, w)
    return qg, qd


def delta_encode(rgb, depth, prev_qg: np.ndarray, prev_qd: np.ndarray, stride: int,
                 max_clamp: float = 0.02):
    """The temporal-delta (P) wire of a frame against the mirrored device
    codes: (packed, new_qg, new_qd), or None where more than max_clamp of
    the residuals clamp (fast motion, a scene cut: the caller ships an I
    wire). The native C encoder (which advances prev_qg / prev_qd in place)
    where it takes the layout, else delta_encode_numpy; counted in
    ENCODES."""
    nat = native_compact.compact_delta(rgb, depth, prev_qg, prev_qd, stride, max_clamp)
    if nat is not None:
        _count("native")
        return None if nat == "clamped" else nat
    _count("numpy")
    return delta_encode_numpy(rgb, depth, prev_qg, prev_qd, stride, max_clamp)


def delta_encode_numpy(rgb, depth, prev_qg: np.ndarray, prev_qd: np.ndarray, stride: int,
                       max_clamp: float = 0.02):
    """The plain numpy version of delta_encode (leaves prev_qg / prev_qd as
    they are)."""
    rgb = np.asarray(rgb)
    depth = np.asarray(depth)
    H, W = depth.shape
    r = (_dither6(_gray8(rgb)) >> 2).astype(np.int16) - prev_qg.astype(np.int16)
    rc = np.clip(r, -8, 7)
    rd = _d10_lut()[_d16(depth)[::stride, ::stride]].astype(np.int32) - prev_qd.astype(np.int32)
    rdc = np.clip(rd, -16, 15)
    n_clamp = int(np.count_nonzero(r != rc)) + int(np.count_nonzero(rd != rdc))
    if n_clamp > max_clamp * (r.size + rd.size):
        return None
    new_qg = (prev_qg.astype(np.int16) + rc).astype(np.uint8)
    new_qd = (prev_qd.astype(np.int32) + rdc).astype(np.uint16)
    packed = np.concatenate([
        _pack4((rc + 8).astype(np.uint8).reshape(-1)),
        _pack5_codes((rdc + 16).astype(np.uint8).reshape(-1)),
        _chroma(rgb, H, W, _chroma_mult(H, W, stride) * stride)])
    return packed, new_qg, new_qd


def maybe_scale_depth(depth, factor: float):
    """depth_scaling_factor (reference misc.cpp:502, node.cpp:705): scale the
    raw depth before the encoder quantizes it. u16 counts become float32
    meters times factor; meters are multiplied by float32(factor)."""
    if factor == 1.0 or depth is None:
        return depth
    depth = np.asarray(depth)
    if depth.dtype == np.uint16:
        return depth.astype(np.float32) * (factor / DEPTH_SCALE)
    return depth * np.float32(factor)


def compact_frame(rgb, depth, stride: int, depth_bits: int = 12,
                  dct: Optional[DctSpec] = None, gray_bits: int = 8,
                  fmt: str = "yc12") -> np.ndarray:
    """Host encoder: rgb (H, W, 3) u8 or (H, W) gray, depth (H, W) u16
    counts or float meters -> one packed u8 buffer. yc12 with 8-, 6- or
    5-bit luma (gray_bits), ydct when `dct` names the luma's rate/quality
    point (H and W divisible by 8, else ValueError), or fmt="raw". The
    native C encoder where it takes the layout, else compact_frame_numpy;
    counted in ENCODES."""
    if depth_bits not in (10, 12):
        raise NotImplementedError(f"tpu_depth_bits={depth_bits} (10 or 12)")
    depth = np.asarray(depth)
    H, W = depth.shape
    if dct is not None:
        check_shape(H, W)
    out = None
    if fmt != "raw":
        cm = _chroma_mult(H, W, stride)
        out = (native_compact.compact_yc12(rgb, depth, stride, depth_bits, cm, gray_bits)
               if dct is None else
               native_compact.compact_ydct(rgb, depth, stride, depth_bits, cm, dct))
    if out is not None:
        _count("native")
        return out
    _count("numpy")
    return compact_frame_numpy(rgb, depth, stride, depth_bits, dct, gray_bits, fmt)


def compact_frame_numpy(rgb, depth, stride: int, depth_bits: int = 12,
                        dct: Optional[DctSpec] = None, gray_bits: int = 8,
                        fmt: str = "yc12") -> np.ndarray:
    """The plain numpy encoder of compact_frame (the JAX package's numpy
    bytes, its grey from the BT.601 fixed-point formula)."""
    if depth_bits not in (10, 12):
        raise NotImplementedError(f"tpu_depth_bits={depth_bits} (10 or 12)")
    rgb = np.asarray(rgb)
    depth = np.asarray(depth)
    H, W = depth.shape
    if dct is not None:
        check_shape(H, W)
    gray8 = _gray8(rgb)
    d16 = _d16(depth)
    if fmt == "raw":
        color = (np.ascontiguousarray(rgb[::stride, ::stride]) if rgb.ndim == 3 else
                 np.zeros((d16[::stride].shape[0], d16[0, ::stride].shape[0], 3), np.uint8))
        return np.concatenate([gray8.reshape(-1),
                               np.ascontiguousarray(d16).view(np.uint8).reshape(-1),
                               color.reshape(-1)])
    dsub = d16[::stride, ::stride].reshape(-1)
    dq = _pack10(_d10_lut()[dsub]) if depth_bits == 10 else _pack12(_d12_lut()[dsub])
    if dct is not None:
        luma = encode_luma_dct(gray8, dct)
    elif gray_bits == 6:
        luma = _pack6(_dither6(gray8).reshape(-1))
    elif gray_bits == 5:
        luma = _pack5(_dither6(gray8, bits=5).reshape(-1))
    else:
        luma = gray8.reshape(-1)
    return np.concatenate([luma, dq, _chroma(rgb, H, W, _chroma_mult(H, W, stride) * stride)])


def _decode_color_small(packed, off: int, gray8, stride: int, cm: int,
                        h: int, w: int, hc: int, wc: int) -> torch.Tensor:
    """Cb/Cr at stride cm*s + the luma plane -> (h, w, 3) u8 (BT.601)."""
    cb = packed[off : off + hc * wc].reshape(hc, wc).float()
    cr = packed[off + hc * wc : off + 2 * hc * wc].reshape(hc, wc).float()
    y = gray8.reshape(h, stride, w, stride).float().mean(dim=(1, 3))

    def up(c):
        return c.repeat_interleave(cm, 0).repeat_interleave(cm, 1)[:h, :w] - 128.0

    cb2, cr2 = up(cb), up(cr)
    r = y + 1.402 * cr2
    g = y - 0.344136 * cb2 - 0.714136 * cr2
    b = y + 1.772 * cb2
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0).to(torch.uint8)


def _unpack6_codes(b: torch.Tensor) -> torch.Tensor:
    """(3K,) u8 -> (4K,) int32 6-bit codes (inverse of _pack6)."""
    g = b.reshape(-1, 3).to(torch.int32)
    return torch.stack([g[:, 0] & 0x3F, (g[:, 0] >> 6) | ((g[:, 1] & 0x0F) << 2),
                        (g[:, 1] >> 4) | ((g[:, 2] & 0x03) << 4), g[:, 2] >> 2],
                       dim=-1).reshape(-1)


def unpack5_codes(b5: torch.Tensor) -> torch.Tensor:
    """(5K,) u8 -> (8K,) int32 values < 32 (inverse of _pack5_codes)."""
    b = b5.reshape(-1, 5).to(torch.int32)
    return torch.stack([
        b[:, 0] & 0x1F, (b[:, 0] >> 5) | ((b[:, 1] & 0x03) << 3), (b[:, 1] >> 2) & 0x1F,
        (b[:, 1] >> 7) | ((b[:, 2] & 0x0F) << 1), (b[:, 2] >> 4) | ((b[:, 3] & 0x01) << 4),
        (b[:, 3] >> 1) & 0x1F, (b[:, 3] >> 6) | ((b[:, 4] & 0x07) << 2), b[:, 4] >> 3,
    ], dim=-1).reshape(-1)


def _unpack10(b: torch.Tensor) -> torch.Tensor:
    """(5K,) u8 -> (4K,) int32 10-bit depth codes (inverse of _pack10)."""
    b = b.reshape(-1, 5).to(torch.int32)
    return torch.stack([b[:, 0] | ((b[:, 1] & 0x03) << 8), (b[:, 1] >> 2) | ((b[:, 2] & 0x0F) << 6),
                        (b[:, 2] >> 4) | ((b[:, 3] & 0x3F) << 4), (b[:, 3] >> 6) | (b[:, 4] << 2)],
                       dim=-1).reshape(-1)


def _gray6(q: torch.Tensor) -> torch.Tensor:
    """6-bit luma codes -> u8 grey by bit replication."""
    return ((q << 2) | (q >> 4)).to(torch.uint8)


def _depth10_m(q: torch.Tensor) -> torch.Tensor:
    """10-bit sqrt depth codes -> metres."""
    qf = q.float()
    return qf * qf * (1.0 / (16.0 * DEPTH_SCALE))


def _luma_len(H: int, W: int, gray_bits: int, dct: Optional[DctSpec]) -> int:
    if dct is not None:
        return dct_luma_len(H, W, dct)
    return {8: H * W, 6: (H * W // 4) * 3, 5: (H * W // 8) * 5}[gray_bits]


def unpack_yc12(packed: torch.Tensor, H: int, W: int, stride: int, depth_bits: int,
                dct: Optional[DctSpec] = None, gray_bits: int = 8, return_codes: bool = False):
    """Device inverse of compact_frame: packed u8 -> (gray u8 (H, W),
    depth_small f32 meters (h, w), color u8 (h, w, 3)) [+ the wire codes
    (6-bit luma u8 (H, W), depth int32 (h, w)) when return_codes: the delta
    wire's state]. `dct` and gray_bits as given to compact_frame; 6- and
    5-bit codes decode by bit replication."""
    h, w = H // stride, W // stride
    cm = _chroma_mult(H, W, stride)
    hc, wc = H // (cm * stride), W // (cm * stride)
    n_gray = _luma_len(H, W, gray_bits, dct)
    codes_g = None
    if dct is not None:
        gray8 = decode_luma_dct_dev(packed[:n_gray], H, W, dct)
    elif gray_bits == 6:
        q = _unpack6_codes(packed[:n_gray]).reshape(H, W)
        gray8 = _gray6(q)
        codes_g = q.to(torch.uint8)
    elif gray_bits == 5:
        q = unpack5_codes(packed[:n_gray]).reshape(H, W)
        gray8 = ((q << 3) | (q >> 2)).to(torch.uint8)
        codes_g = q.to(torch.uint8)
    else:
        gray8 = packed[:n_gray].reshape(H, W)
    if depth_bits == 10:
        n_d = (h * w // 4) * 5
        qi = _unpack10(packed[n_gray : n_gray + n_d]).reshape(h, w)
        depth_small = _depth10_m(qi)
    else:
        n_d = (h * w // 2) * 3
        b = packed[n_gray : n_gray + n_d].reshape(-1, 3).to(torch.int32)
        q0 = b[:, 0] | ((b[:, 1] & 0x0F) << 8)
        q1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
        qi = torch.stack([q0, q1], dim=-1).reshape(h, w)
        q = qi.float()
        depth_small = q * q * (1.0 / (256.0 * DEPTH_SCALE))
    color = _decode_color_small(packed, n_gray + n_d, gray8, stride, cm, h, w, hc, wc)
    if return_codes:
        return gray8, depth_small, color, (codes_g, qi)
    return gray8, depth_small, color


def unpack_raw(packed: torch.Tensor, H: int, W: int, stride: int):
    """Device inverse of compact_frame(fmt="raw"): (gray u8 (H, W), depth
    int32 counts (H, W), color u8 (ceil(H/s), ceil(W/s), 3))."""
    n_gray, n_depth = H * W, 2 * H * W
    h, w = -(-H // stride), -(-W // stride)
    gray8 = packed[:n_gray].reshape(H, W)
    d8 = packed[n_gray : n_gray + n_depth].reshape(H * W, 2).to(torch.int32)
    depth16 = (d8[:, 0] | (d8[:, 1] << 8)).reshape(H, W)
    color = packed[n_gray + n_depth : n_gray + n_depth + h * w * 3].reshape(h, w, 3)
    return gray8, depth16, color


def intra_codes(packed: torch.Tensor, H: int, W: int, stride: int):
    """The 6-bit luma codes (H, W) and 10-bit depth codes (h, w), int32, of
    an I wire (6/10-bit yc12)."""
    n_gray = (H * W // 4) * 3
    h, w = H // stride, W // stride
    return (_unpack6_codes(packed[:n_gray]).reshape(H, W),
            _unpack10(packed[n_gray : n_gray + (h * w // 4) * 5]).reshape(h, w))


def delta_codes(packed: torch.Tensor, H: int, W: int, stride: int, wire_prev):
    """The codes of a delta (P) wire against the previous frame's
    reconstructed codes wire_prev = (luma (H, W), depth (h, w)): luma
    clamp(prev + r, 0, 63) from 4-bit residuals, depth clamp(prev + r, 0,
    1023) from 5-bit ones; int32. The host encoder mirrors this integer
    arithmetic exactly."""
    h, w = H // stride, W // stride
    prev_g, prev_d = wire_prev
    n_l = H * W // 2
    b = packed[:n_l].to(torch.int32)
    r = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(H, W) - 8
    qg = torch.clamp(prev_g.to(torch.int32) + r, 0, 63)
    rd = unpack5_codes(packed[n_l : n_l + (h * w // 8) * 5]).reshape(h, w) - 16
    return qg, torch.clamp(prev_d.to(torch.int32) + rd, 0, 1023)


def _decode_codes(packed, chroma_off: int, qg, qd, H: int, W: int, stride: int):
    """(gray u8, depth_small f32 metres, color u8) from 6/10-bit codes and
    the chroma tail at chroma_off."""
    h, w = H // stride, W // stride
    cm = _chroma_mult(H, W, stride)
    hc, wc = H // (cm * stride), W // (cm * stride)
    gray8 = _gray6(qg)
    return (gray8, _depth10_m(qd),
            _decode_color_small(packed, chroma_off, gray8, stride, cm, h, w, hc, wc))


def unpack_yc12_delta(packed: torch.Tensor, H: int, W: int, stride: int, wire_prev):
    """Device decode of a delta (P) wire against wire_prev (delta_codes):
    (gray u8, depth_small f32 meters, color u8, (luma codes u8, depth codes
    int32))."""
    qg, qd = delta_codes(packed, H, W, stride, wire_prev)
    off = wire_delta_len(H, W, stride) - 2 * _chroma_plane(H, W, stride)
    return (*_decode_codes(packed, off, qg, qd, H, W, stride), (qg.to(torch.uint8), qd))


def finish_yc12(extractor, cam, stride: int, min_depth: float, max_depth: float,
                use_feature_min_depth: bool, gray8: torch.Tensor, depth_m: torch.Tensor):
    """Depth masking, the nearest-upsampled feature-depth plane and keypoint
    extraction. Returns (Keypoints, depth_small)."""
    H, W = cam.height, cam.width
    valid_s = (depth_m > min_depth) & (depth_m < max_depth)
    depth_small = torch.where(valid_s, depth_m, 0.0)
    depth_full = depth_small.repeat_interleave(stride, 0).repeat_interleave(stride, 1)[:H, :W]
    gray = gray8.float() * (1.0 / 255.0)
    kp = extractor(gray, feature_depth_map(depth_full, depth_full > 0, use_feature_min_depth), cam)
    return kp, depth_small


def prepare_and_extract(extractor, cam, stride, min_depth, max_depth,
                        use_feature_min_depth, packed, depth_bits, dct=None, gray_bits=8,
                        fmt="yc12"):
    """Unpack one yc12/ydct/raw buffer and extract: (Keypoints,
    depth_small, color_small)."""
    if fmt == "raw":
        gray8, depth16, color_small = unpack_raw(packed, cam.height, cam.width, stride)
        depth = depth16.float() * (1.0 / DEPTH_SCALE)
        valid = (depth > min_depth) & (depth < max_depth)
        depth = torch.where(valid, depth, 0.0)
        gray = gray8.float() * (1.0 / 255.0)
        kp = extractor(gray, feature_depth_map(depth, valid, use_feature_min_depth), cam)
        return kp, depth[::stride, ::stride], color_small
    gray8, depth_m, color_small = unpack_yc12(packed, cam.height, cam.width, stride,
                                              depth_bits, dct, gray_bits)
    kp, depth_small = finish_yc12(extractor, cam, stride, min_depth, max_depth,
                                  use_feature_min_depth, gray8, depth_m)
    return kp, depth_small, color_small


def prepare_and_extract_wire(extractor, cam, stride, min_depth, max_depth,
                             use_feature_min_depth, packed, intra: torch.Tensor, wire):
    """The delta wire's unpack and extract. packed: an I wire (6/10-bit
    yc12) or a P wire padded to the I length; intra: () bool on the device,
    True for an I wire; wire: the (luma u8 (H, W), depth int32 (h, w))
    codes of the previous frame, overwritten in place with this frame's.
    Both decodes run and the codes are selected by `intra`, so one captured
    step serves I and P frames alike (the JAX package dispatches on the
    buffer length, one compiled step each)."""
    H, W = cam.height, cam.width
    qg_i, qd_i = intra_codes(packed, H, W, stride)
    qg_p, qd_p = delta_codes(packed, H, W, stride, wire)
    qg = torch.where(intra, qg_i, qg_p)
    qd = torch.where(intra, qd_i, qd_p)
    n_c = 2 * _chroma_plane(H, W, stride)
    off_i = wire_intra_len(H, W, stride) - n_c
    off_p = wire_delta_len(H, W, stride) - n_c
    chroma = torch.where(intra, packed[off_i : off_i + n_c], packed[off_p : off_p + n_c])
    gray8, depth_m, color_small = _decode_codes(chroma, 0, qg, qd, H, W, stride)
    wire[0].copy_(qg.to(torch.uint8))
    wire[1].copy_(qd)
    kp, depth_small = finish_yc12(extractor, cam, stride, min_depth, max_depth,
                                  use_feature_min_depth, gray8, depth_m)
    return kp, depth_small, color_small
