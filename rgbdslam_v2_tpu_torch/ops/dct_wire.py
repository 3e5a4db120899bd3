"""Fixed-rate 8x8 block-DCT luma wire (``tpu_ingest_format="ydct"``).

Port of ``rgbdslam_v2_tpu/ops/dct_wire.py``: the orthonormal DCT-II matrix
``DCT8``, the JPEG ``ZIGZAG``, the three named rate/quality points
``SPECS`` ("2.3", "2.7", "3.1": bits and quantizer step per coded zigzag
position), ``dct_luma_len``, the numpy host encoder ``encode_luma_dct``
(two thin GEMMs and one packbits a coded position), the numpy decoder
``decode_luma_dct_np`` (with ``luma_codes_np``, JAX ``_decode_codes_np``)
and the device decoder ``decode_luma_dct_dev``; ``code_delta_np`` says how
far two encoders' codes may move the decoded pixels.

The JAX module keeps the chosen spec in process globals (``set_quality``).
Here the spec is a value: :func:`spec` returns the :class:`DctSpec` of a
name (``ValueError`` for an unknown one), and the encoder, the decoders and
the manager's starvation alert take it as an argument.

Wire layout, per coded position p in zigzag order: the p-th code of every
block, ``BIT_ALLOC[p]`` bits each, most significant bit first, packed into
``ceil(n_blocks * bits / 8)`` bytes. DC is coded unsigned; AC codes carry
an offset of ``2^(bits-1)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from .. import backend


def _dct8() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (float32): D @ D.T == I."""
    k = np.arange(8)[:, None].astype(np.float64)
    n = np.arange(8)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * n + 1) * k / 16.0) * np.sqrt(2.0 / 8.0)
    d[0] *= np.sqrt(0.5)
    return d.astype(np.float32)


DCT8 = _dct8()

# standard JPEG zigzag: ZIGZAG[p] = row-major index of zigzag position p
_zz = sorted((u + v, v if (u + v) % 2 == 0 else u, u * 8 + v)
             for u in range(8) for v in range(8))
ZIGZAG = np.asarray([idx for _, _, idx in _zz], np.int32)

# (bits, quantizer step) per zigzag position; positions beyond the list are
# not coded (their synthesis rows are zero)
SPECS = {
    "2.3": [
        (11, 1.0),
        (8, 6.0), (8, 6.0),
        (7, 8.0), (7, 8.0), (7, 8.0),
        (6, 10.0), (6, 10.0), (6, 10.0), (6, 10.0),
        (5, 14.0), (5, 14.0), (5, 14.0), (5, 14.0), (5, 14.0),
        (4, 20.0), (4, 20.0), (4, 20.0), (4, 20.0),
        (4, 24.0), (4, 24.0), (4, 24.0), (4, 24.0), (4, 24.0),
        (3, 32.0), (3, 32.0), (3, 32.0), (3, 32.0),
    ],
    "2.7": [
        (11, 1.0),
        (9, 3.0), (9, 3.0),
        (8, 4.0), (8, 4.0), (8, 4.0),
        (7, 5.0), (7, 5.0), (7, 5.0), (7, 5.0),
        (6, 7.0), (6, 7.0), (6, 7.0), (6, 7.0), (6, 7.0),
        (5, 10.0), (5, 10.0), (5, 10.0), (5, 10.0),
        (5, 12.0), (5, 12.0), (5, 12.0), (5, 12.0), (5, 12.0),
        (4, 16.0), (4, 16.0), (4, 16.0), (4, 16.0),
    ],
}
SPECS["3.1"] = SPECS["2.7"] + [(3, 24.0)] * 8


@dataclasses.dataclass(frozen=True, eq=False)
class DctSpec:
    """One named rate/quality point: bits and quantizer step per coded
    zigzag position, and the (K, 64) synthesis basis."""

    name: str
    bit_alloc: np.ndarray  # (K,) int32
    qstep: np.ndarray  # (K,) float32
    synthesis: np.ndarray  # (K, 64) float32: row p = zigzag pattern p

    @property
    def k_coded(self) -> int:
        return len(self.bit_alloc)

    @property
    def bits_per_block(self) -> int:
        return int(self.bit_alloc.sum())


_spec_cache: Dict[str, DctSpec] = {}


def _synthesis_basis(k: int) -> np.ndarray:
    B = np.zeros((k, 64), np.float32)
    for p in range(k):
        u, v = divmod(int(ZIGZAG[p]), 8)
        B[p] = np.outer(DCT8[u], DCT8[v]).reshape(-1)
    return B


def spec(name) -> DctSpec:
    """The DctSpec named `name` (tpu_dct_quality); ValueError when unknown."""
    name = str(name)
    if name not in SPECS:
        raise ValueError(f"unknown tpu_dct_quality {name!r}; choose from {sorted(SPECS)}")
    s = _spec_cache.get(name)
    if s is None:
        table = SPECS[name]
        s = DctSpec(name=name,
                    bit_alloc=np.asarray([b for b, _ in table], np.int32),
                    qstep=np.asarray([q for _, q in table], np.float32),
                    synthesis=_synthesis_basis(len(table)))
        for a in (s.bit_alloc, s.qstep, s.synthesis):
            a.setflags(write=False)
        _spec_cache[name] = s
    return s


def check_shape(H: int, W: int) -> None:
    if H % 8 or W % 8:
        raise ValueError(f"the ydct wire needs a frame divisible by 8, got {W}x{H}")


def dct_luma_len(H: int, W: int, sp: DctSpec) -> int:
    """Wire bytes of one (H, W) luma plane (H, W divisible by 8)."""
    n_blocks = (H // 8) * (W // 8)
    return sum((n_blocks * int(b) + 7) // 8 for b in sp.bit_alloc)


def dc_len(H: int, W: int, sp: DctSpec) -> int:
    """Bytes of the DC bit plane (the block means), the wire's first."""
    return ((H // 8) * (W // 8) * int(sp.bit_alloc[0]) + 7) // 8


def _blockify(img: np.ndarray) -> np.ndarray:
    """(H, W) -> (N, 8, 8) row-major blocks."""
    H, W = img.shape
    return img.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def encode_luma_dct(gray8: np.ndarray, sp: DctSpec) -> np.ndarray:
    """Host encode: u8 (H, W) -> packed u8 wire bytes. Separable DCT as two
    thin GEMMs over reshaped views, then per-position quantize + packbits."""
    H, W = gray8.shape
    check_shape(H, W)
    x = gray8.astype(np.float32)
    y = (x.reshape(-1, 8) @ DCT8.T).reshape(H, W)  # along W
    y = (np.ascontiguousarray(y.T).reshape(-1, 8) @ DCT8.T).reshape(W, H).T  # along H
    coef = _blockify(np.ascontiguousarray(y)).reshape(-1, 64)[:, ZIGZAG[: sp.k_coded]]
    out = []
    for p in range(sp.k_coded):
        b, s = int(sp.bit_alloc[p]), float(sp.qstep[p])
        half = 1 << (b - 1)
        if p == 0:  # DC = 8 x block mean, in [0, 2040]: unsigned
            q = np.clip(np.rint(coef[:, 0] / s).astype(np.int32),
                        0, (1 << b) - 1).astype(np.uint32)
        else:
            q = (np.clip(np.rint(coef[:, p] / s).astype(np.int32), -half, half - 1)
                 + half).astype(np.uint32)
        bits = ((q[:, None] >> np.arange(b - 1, -1, -1, dtype=np.uint32)) & 1).astype(np.uint8)
        out.append(np.packbits(bits.reshape(-1)))
    return np.concatenate(out)


def luma_codes_np(packed: np.ndarray, H: int, W: int, sp: DctSpec) -> np.ndarray:
    """The coded integers of a luma wire: (n_blocks, K) int32, position p's
    code as written (DC unsigned, AC with its 2^(bits-1) offset)."""
    n_blocks = (H // 8) * (W // 8)
    codes = np.zeros((n_blocks, sp.k_coded), np.int32)
    off = 0
    for p in range(sp.k_coded):
        b = int(sp.bit_alloc[p])
        nb = (n_blocks * b + 7) // 8
        bits = np.unpackbits(packed[off : off + nb])[: n_blocks * b].reshape(n_blocks, b)
        codes[:, p] = (bits.astype(np.uint32) @ (1 << np.arange(b - 1, -1, -1, dtype=np.uint32))
                       ).astype(np.int32)
        off += nb
    return codes


def code_delta_np(codes_a: np.ndarray, codes_b: np.ndarray, H: int, W: int,
                  sp: DctSpec) -> np.ndarray:
    """(H, W) float32: what the difference of two code arrays (luma_codes_np
    of two wires) adds to the decoder's pixels before rounding, since the
    decode is linear in the codes: a bound, within 1 for the rounding, of
    how far the two wires' decodes may differ."""
    coef = (codes_a - codes_b).astype(np.float32) * sp.qstep
    blocks = coef @ sp.synthesis
    return blocks.reshape(H // 8, W // 8, 8, 8).transpose(0, 2, 1, 3).reshape(H, W)


def decode_luma_dct_np(packed: np.ndarray, H: int, W: int, sp: DctSpec) -> np.ndarray:
    """Numpy reference decode: wire -> u8 (H, W)."""
    q = luma_codes_np(packed, H, W, sp)
    half = np.asarray([0] + [1 << (int(b) - 1) for b in sp.bit_alloc[1:]], np.int32)
    coef = (q - half).astype(np.float32) * sp.qstep
    blocks = coef @ sp.synthesis
    img = blocks.reshape(H // 8, W // 8, 8, 8).transpose(0, 2, 1, 3).reshape(H, W)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def _decode_tables(H: int, W: int, sp: DctSpec):
    """Host tables of the device decode: for every (block, coded bit) the
    wire byte and the bit's shift in it, the (bits, K) place-value matrix
    that sums a position's bits into its code, and the per-position code
    offset and quantizer step."""
    n_blocks = (H // 8) * (W // 8)
    total = sp.bits_per_block
    byte_idx = np.empty((n_blocks, total), np.int64)
    shift = np.empty((n_blocks, total), np.int32)
    place = np.zeros((total, sp.k_coded), np.float32)
    blk = np.arange(n_blocks, dtype=np.int64)[:, None]
    off, col = 0, 0
    for p, b in enumerate(int(x) for x in sp.bit_alloc):
        g = blk * b + np.arange(b, dtype=np.int64)[None, :]  # bit index in plane p
        byte_idx[:, col : col + b] = off + g // 8
        shift[:, col : col + b] = 7 - g % 8
        place[col : col + b, p] = 2.0 ** np.arange(b - 1, -1, -1)
        off += (n_blocks * b + 7) // 8
        col += b
    offset = np.asarray([0.0] + [float(1 << (int(b) - 1)) for b in sp.bit_alloc[1:]],
                        np.float32)
    return byte_idx, shift, place, offset, sp.qstep.copy()


def decode_luma_dct_dev(packed: torch.Tensor, H: int, W: int, sp: DctSpec) -> torch.Tensor:
    """Device decode: packed u8 wire (1-D tensor) -> u8 (H, W) luma.

    One gather pulls every block's coded bits out of the wire; a product
    with the place-value matrix sums them into codes (exact in float32:
    codes < 2^11); codes minus offset times step are the coefficients
    (exact); ONE (N_blocks, K) x (K, 64) product synthesises the blocks.
    Matches decode_luma_dct_np, and the JAX package's decode, bit for bit
    (tests/test_torch_dct_wire.py)."""
    dev = packed.device
    key = ("dct_decode", sp.name, H, W)
    byte_idx, shift, place, offset, qstep = (
        backend.constant(key + (i,), lambda i=i: _decode_tables(H, W, sp)[i], dev)
        for i in range(5))
    synth = backend.constant(("dct_synthesis", sp.name), lambda: sp.synthesis.copy(), dev)
    bits = (packed[byte_idx].to(torch.int32) >> shift) & 1
    q = bits.to(torch.float32) @ place
    blocks = ((q - offset) * qstep) @ synth
    img = blocks.reshape(H // 8, W // 8, 8, 8).transpose(1, 2).reshape(H, W)
    return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)
