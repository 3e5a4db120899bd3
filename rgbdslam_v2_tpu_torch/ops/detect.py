"""Fused FAST+Harris+NMS corner scoring of a whole pyramid: the hand-written
CUDA kernel.

Port of ``rgbdslam_v2_tpu/ops/pallas_detect.py::detect_corners_pallas``
(the repo's one Pallas kernel) as ``csrc/detect_corners.cu`` for sm_90a,
built by ``backend.load_kernel_library`` at first use and called through
ctypes on torch's current stream.

Each level is its own (h, w) float32 image in the *level layout*: rows
``pitch = w`` rounded up to 4 floats apart and a 16-byte aligned start, as
the kernel's TMA copies need (:func:`pitched_empty` allocates one,
:func:`as_level` makes any image conform). Widths that are multiples of 4
are plain contiguous images. The level table (:func:`level_table`, one row
per level) holds:

* ``pitch``, ``h``, ``w``: the level's row pitch and shape;
* ``out_off``: its ``(h, w)`` score map is ``out[out_off : out_off + h*w]``
  of one flat output, unpitched;
* ``blocks_x``, ``blocks_y``, ``block_start``: the level's grid of
  ``TILE_W x TILE_H`` output tiles and the exclusive prefix sum of tile
  counts, which maps the kernel's flat block index to (level, tile).

:func:`detect_pyramid` scores every level: CUDA levels in one kernel launch
(or it raises), CPU levels through the plain version ``ops/fast.detect_corners``
level by level. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import numpy as np
import torch

from .. import backend
from .fast import detect_corners as detect_corners_plain
from .image import gaussian_kernel_1d

HARRIS_K = 0.04
LAUNCHES = 0  # kernel launches (incremented only where the kernel launches)

TILE_W = 120  # output columns of one thread block (csrc/detect_corners.cu)
TILE_H = 32  # output rows of one thread block
MAX_LEVELS = 8
# level table columns
PITCH, H, W, OUT_OFF, BLOCKS_X, BLOCKS_Y, BLOCK_START = range(7)

# 5-tap sigma=1.5 blur of ops.image.harris_response, passed by host pointer
_TAPS = np.ascontiguousarray(gaussian_kernel_1d(1.5, 2), np.float32)
_fn = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=32)
def _level_table(shapes) -> np.ndarray:
    rows, out_off, start = [], 0, 0
    for h, w in shapes:
        bx, by = -(-w // TILE_W), -(-h // TILE_H)
        rows.append((_round4(w), h, w, out_off, bx, by, start))
        out_off = _round4(out_off + h * w)
        start += bx * by
    table = np.ascontiguousarray(rows, dtype=np.int32)
    table.setflags(write=False)
    return table


def level_table(shapes) -> np.ndarray:
    """(levels, 7) int32 table for level shapes [(h, w), ...]; see the module
    docstring for the columns."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"{len(shapes)} levels; the kernel takes 1 to {MAX_LEVELS}")
    return _level_table(shapes)


def output_size(table: np.ndarray) -> int:
    last = table[-1]
    return int(last[OUT_OFF] + last[H] * last[W])


def pitched_empty(h: int, w: int, device) -> torch.Tensor:
    """An uninitialised (h, w) float32 image in the level layout."""
    return torch.empty((h, _round4(w)), dtype=torch.float32, device=device)[:, :w]


def _in_layout(img: torch.Tensor) -> bool:
    return (img.dtype == torch.float32 and img.dim() == 2
            and img.stride() == (_round4(img.shape[1]), 1) and img.data_ptr() % 16 == 0)


def as_level(img: torch.Tensor) -> torch.Tensor:
    """`img` itself when it is in the level layout, else a copy that is."""
    if _in_layout(img):
        return img
    out = pitched_empty(*img.shape, img.device)
    out.copy_(img)
    return out


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = backend.load_kernel_library("detect_corners")
        fn = lib.detect_pyramid_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(levels: Sequence[torch.Tensor], border: int) -> np.ndarray:
    """The level table of `levels`, after checking their layout and border."""
    for img in levels:
        if not _in_layout(img):
            raise ValueError(
                f"level {img.dtype} {tuple(img.shape)} stride {img.stride()} is not a "
                "16-byte aligned float32 image with rows 4 floats apart (see as_level)")
    table = level_table([img.shape for img in levels])
    # every output within `border` of an edge is -inf, so no output reads a
    # pixel outside its level (the kernel's zero fill never reaches a score)
    for h, w in table[:, [H, W]]:
        if border < 4 or h <= 2 * border or w <= 2 * border:
            raise ValueError(f"border {border} must be >= 4 and leave an interior "
                             f"in a {h}x{w} level")
    return table


def _score_maps(out: torch.Tensor, table: np.ndarray) -> List[torch.Tensor]:
    return [out[o : o + h * w].view(h, w)
            for h, w, o in table[:, [H, W, OUT_OFF]].tolist()]


def detect_pyramid_cuda(levels: Sequence[torch.Tensor], threshold: float, border: int = 16,
                        harris_k: float = HARRIS_K) -> List[torch.Tensor]:
    """One kernel launch scoring every CUDA level."""
    global LAUNCHES
    device = levels[0].device
    if not all(img.is_cuda and img.device == device for img in levels):
        raise ValueError("detect_pyramid_cuda needs CUDA tensors on one device")
    table = _check(levels, border)
    fn = _kernel_fn()
    ptrs = (ctypes.c_void_p * len(levels))(*[img.data_ptr() for img in levels])
    out = torch.empty(output_size(table), dtype=torch.float32, device=device)
    status = fn(
        ptrs, out.data_ptr(), table.ctypes.data, len(table),
        float(threshold), float(harris_k), int(border), _TAPS.ctypes.data,
        torch.cuda.current_stream(device).cuda_stream,
    )
    backend.check_launch(status, "detect_pyramid_f32")
    LAUNCHES += 1
    return _score_maps(out, table)


def detect_pyramid_plain(levels: Sequence[torch.Tensor], threshold: float,
                         border: int = 16) -> List[torch.Tensor]:
    """The plain version, level by level, into the same flat output layout."""
    table = _check(levels, border)
    out = torch.empty(output_size(table), dtype=torch.float32, device=levels[0].device)
    maps = _score_maps(out, table)
    for img, m in zip(levels, maps):
        m.copy_(detect_corners_plain(img, threshold=threshold, border=border))
    return maps


def detect_pyramid(levels: Sequence[torch.Tensor], threshold: float,
                   border: int = 16) -> List[torch.Tensor]:
    """Harris-ranked FAST corners with 3x3 NMS on every level (each in the
    level layout): one contiguous (h, w) score map a level, -inf at
    non-keypoints, all views of one flat buffer. CPU levels -> plain
    version; CUDA -> the kernel."""
    if len(levels) and levels[0].is_cuda:
        return detect_pyramid_cuda(levels, threshold, border)
    return detect_pyramid_plain(levels, threshold, border)
