"""The frame the program's extractor sees, worked out plainly from the raw
frame: the configurations' host-to-card wire (``tpu_ingest_format`` ydct),
encoded and decoded.

* luma: BT.601 fixed-point grey ((77 R + 150 G + 29 B) >> 8); 8x8 blocks,
  an orthonormal DCT-II (basis rounded to float32, sums in float64), the
  first k zigzag coefficients quantized to the named rate point's steps
  (round half to even; DC unsigned, AC clipped to their bits), decoded by
  the inverse transform and rounded to u8;
* depth: the u16 counts (5000 a metre) sampled every `stride` pixels,
  coded q = round(sqrt(16 d)) clipped to 10 bits, decoded to q^2 / 80000 m.

Rate points: the JAX package's published ydct table (2.7 bits a pixel:
bits and quantizer step per coded zigzag position).
"""
from __future__ import annotations

import numpy as np

# (bits, quantizer step) per zigzag position of the "2.7" rate point
SPECS = {
    "2.7": [(11, 1.0)] + [(9, 3.0)] * 2 + [(8, 4.0)] * 3 + [(7, 5.0)] * 4 + [(6, 7.0)] * 5
    + [(5, 10.0)] * 4 + [(5, 12.0)] * 5 + [(4, 16.0)] * 4,
}
DEPTH_SCALE = 5000.0


def _dct8() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / 16.0) * np.sqrt(2.0 / 8.0)
    d[0] *= np.sqrt(0.5)
    return d.astype(np.float32).astype(np.float64)


DCT8 = _dct8()
# JPEG zigzag: ZIGZAG[p] = the row-major index of zigzag position p
ZIGZAG = np.asarray([i for _, _, i in sorted(
    (u + v, v if (u + v) % 2 == 0 else u, u * 8 + v) for u in range(8) for v in range(8))])


def gray8(rgb: np.ndarray) -> np.ndarray:
    r = rgb.astype(np.uint16)
    return ((r[..., 0] * 77 + r[..., 1] * 150 + r[..., 2] * 29) >> 8).astype(np.uint8)


def luma_through_wire(g8: np.ndarray, quality: str) -> np.ndarray:
    """u8 (H, W) -> the u8 (H, W) luma the wire delivers."""
    H, W = g8.shape
    table = SPECS[str(quality)]
    k = len(table)
    bits = np.asarray([b for b, _ in table])
    step = np.asarray([s for _, s in table])
    blocks = g8.astype(np.float64).reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ui,abij,vj->abuv", DCT8, blocks, DCT8).reshape(H // 8, W // 8, 64)
    coef = coef[..., ZIGZAG[:k]]
    q = np.rint(coef / step)
    half = 2.0 ** (bits - 1)
    lo = np.where(np.arange(k) == 0, 0.0, -half)
    hi = np.where(np.arange(k) == 0, 2.0 ** bits - 1, half - 1)
    q = np.clip(q, lo, hi)
    full = np.zeros((H // 8, W // 8, 64))
    full[..., ZIGZAG[:k]] = q * step
    full = full.reshape(H // 8, W // 8, 8, 8)
    img = np.einsum("ui,abuv,vj->abij", DCT8, full, DCT8)
    img = img.transpose(0, 2, 1, 3).reshape(H, W)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def depth_through_wire(d16: np.ndarray, stride: int) -> np.ndarray:
    """u16 counts (H, W) -> the (H / stride, W / stride) metres the wire
    delivers."""
    sub = d16[::stride, ::stride].astype(np.float64)
    q = np.clip(np.rint(np.sqrt(sub * 16.0)), 0, 1023)
    return q * q / (16.0 * DEPTH_SCALE)


def frame(rgb: np.ndarray, d16: np.ndarray, params: dict):
    """(grey u8 (H, W), depth metres (h, w)) of one raw frame."""
    assert params["tpu_ingest_format"] == "ydct" and params["tpu_depth_bits"] == 10
    return (luma_through_wire(gray8(rgb), params["tpu_dct_quality"]),
            depth_through_wire(d16, params["cloud_creation_skip_step"]))
