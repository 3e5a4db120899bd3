"""The yc12 and ydct ingest wires: host packing and device unpacking.

Port of the yc12 and ydct parts of ``rgbdslam_v2_tpu/graph/manager.py``:

* host side: ``maybe_scale_depth``, ``compact_frame`` (its yc12 branch
  with gray_bits 8 and its ydct branch), through the native C encoder (``io/native_compact.py``)
  as the JAX package does, with the numpy encoder as the plain version and
  the fallback for layouts the C code refuses: ``compact_frame_numpy``,
  ``_d10_lut``/``_pack10``, ``_d12_lut``/``_pack12``, ``_chroma_mult``;
* device side, torch: ``_unpack_yc12`` (8-bit and DCT luma),
  ``_decode_color_small`` and ``_finish_yc12`` (depth masking,
  feature-depth plane, extraction).

Wire layout: [luma | sqrt-coded depth at stride s (10 or 12 bits) | Cb | Cr
at stride cm*s]. The luma is H*W u8 bytes (yc12) or the fixed-rate block-DCT
planes of ``ops/dct_wire.py`` (ydct, chosen by passing its ``DctSpec``).
Native yc12 bytes equal the numpy bytes; native ydct codes may differ from
the numpy codes by 1 at ~2e-3 of positions, mostly DC codes on an exact .5
tie (``io/native_compact.py``).
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
                  dct: Optional[DctSpec] = None) -> np.ndarray:
    """Host encoder: rgb (H, W, 3) u8 or (H, W) gray, depth (H, W) u16
    counts or float meters -> one packed u8 buffer. yc12 with 8-bit luma,
    or ydct when `dct` names the luma's rate/quality point (H and W
    divisible by 8, else ValueError). The native C encoder where it takes
    the layout, else compact_frame_numpy; counted in ENCODES."""
    if depth_bits not in (10, 12):
        raise NotImplementedError(f"tpu_depth_bits={depth_bits} (10 or 12)")
    depth = np.asarray(depth)
    H, W = depth.shape
    if dct is not None:
        check_shape(H, W)
    cm = _chroma_mult(H, W, stride)
    out = (native_compact.compact_yc12(rgb, depth, stride, depth_bits, cm) if dct is None
           else native_compact.compact_ydct(rgb, depth, stride, depth_bits, cm, dct))
    if out is not None:
        _count("native")
        return out
    _count("numpy")
    return compact_frame_numpy(rgb, depth, stride, depth_bits, dct)


def compact_frame_numpy(rgb, depth, stride: int, depth_bits: int = 12,
                        dct: Optional[DctSpec] = None) -> np.ndarray:
    """The plain numpy encoder of compact_frame (the JAX package's numpy
    bytes)."""
    if depth_bits not in (10, 12):
        raise NotImplementedError(f"tpu_depth_bits={depth_bits} (10 or 12)")
    rgb = np.asarray(rgb)
    depth = np.asarray(depth)
    H, W = depth.shape
    if dct is not None:
        check_shape(H, W)
    if rgb.ndim == 3:
        r16 = rgb.astype(np.uint16)
        gray8 = ((r16[..., 0] * 77 + r16[..., 1] * 150 + r16[..., 2] * 29) >> 8).astype(np.uint8)
    elif rgb.dtype == np.uint8:
        gray8 = rgb
    else:
        scale = 255.0 if rgb.dtype.kind == "f" else 1.0
        gray8 = np.clip(rgb * scale, 0, 255).astype(np.uint8)
    if depth.dtype == np.uint16:
        d16 = depth
    else:
        d = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
        d16 = np.clip(d * DEPTH_SCALE, 0, 65535).astype(np.uint16)
    dsub = d16[::stride, ::stride].reshape(-1)
    dq = _pack10(_d10_lut()[dsub]) if depth_bits == 10 else _pack12(_d12_lut()[dsub])
    cs = _chroma_mult(H, W, stride) * stride
    if rgb.ndim == 3:
        sub = rgb[::cs, ::cs].astype(np.float32)
        r, g, b = sub[..., 0], sub[..., 1], sub[..., 2]
        cb = np.clip(128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b, 0, 255).astype(np.uint8)
        cr = np.clip(128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b, 0, 255).astype(np.uint8)
    else:
        cb = np.full((H // cs, W // cs), 128, np.uint8)
        cr = np.full((H // cs, W // cs), 128, np.uint8)
    luma = gray8.reshape(-1) if dct is None else encode_luma_dct(gray8, dct)
    return np.concatenate([luma, dq, cb.reshape(-1), cr.reshape(-1)])


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


def unpack_yc12(packed: torch.Tensor, H: int, W: int, stride: int, depth_bits: int,
                dct: Optional[DctSpec] = None):
    """Device inverse of compact_frame: packed u8 -> (gray u8 (H, W),
    depth_small f32 meters (h, w), color u8 (h, w, 3)). `dct` as given to
    compact_frame."""
    h, w = H // stride, W // stride
    cm = _chroma_mult(H, W, stride)
    hc, wc = H // (cm * stride), W // (cm * stride)
    if dct is None:
        n_gray = H * W
        gray8 = packed[:n_gray].reshape(H, W)
    else:
        n_gray = dct_luma_len(H, W, dct)
        gray8 = decode_luma_dct_dev(packed[:n_gray], H, W, dct)
    if depth_bits == 10:
        n_d = (h * w // 4) * 5
        b = packed[n_gray : n_gray + n_d].reshape(-1, 5).to(torch.int32)
        q0 = b[:, 0] | ((b[:, 1] & 0x03) << 8)
        q1 = (b[:, 1] >> 2) | ((b[:, 2] & 0x0F) << 6)
        q2 = (b[:, 2] >> 4) | ((b[:, 3] & 0x3F) << 4)
        q3 = (b[:, 3] >> 6) | (b[:, 4] << 2)
        q = torch.stack([q0, q1, q2, q3], dim=-1).reshape(h, w).float()
        depth_small = q * q * (1.0 / (16.0 * DEPTH_SCALE))
    else:
        n_d = (h * w // 2) * 3
        b = packed[n_gray : n_gray + n_d].reshape(-1, 3).to(torch.int32)
        q0 = b[:, 0] | ((b[:, 1] & 0x0F) << 8)
        q1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
        q = torch.stack([q0, q1], dim=-1).reshape(h, w).float()
        depth_small = q * q * (1.0 / (256.0 * DEPTH_SCALE))
    color = _decode_color_small(packed, n_gray + n_d, gray8, stride, cm, h, w, hc, wc)
    return gray8, depth_small, color


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
                        use_feature_min_depth, packed, depth_bits, dct=None):
    """Unpack one yc12/ydct buffer and extract: (Keypoints, depth_small,
    color_small)."""
    gray8, depth_m, color_small = unpack_yc12(packed, cam.height, cam.width, stride,
                                              depth_bits, dct)
    kp, depth_small = finish_yc12(extractor, cam, stride, min_depth, max_depth,
                                  use_feature_min_depth, gray8, depth_m)
    return kp, depth_small, color_small
