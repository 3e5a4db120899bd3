"""Fused FAST+Harris+NMS corner scoring: the hand-written CUDA kernel.

Port of ``rgbdslam_v2_tpu/ops/pallas_detect.py::detect_corners_pallas``
(the repo's one Pallas kernel) as ``csrc/detect_corners.cu`` for sm_90a,
built by ``backend.load_kernel_library`` at first use and called through
ctypes on torch's current stream.

``detect_corners`` takes a (H, W) float32 image. A CPU tensor goes to the
plain version (``ops/fast.detect_corners``); a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import backend
from .fast import detect_corners as detect_corners_plain
from .image import gaussian_kernel_1d

HARRIS_K = 0.04
LAUNCHES = 0  # kernel launches (incremented only where the kernel launches)

# 5-tap sigma=1.5 blur of ops.image.harris_response, passed by host pointer
_TAPS = np.ascontiguousarray(gaussian_kernel_1d(1.5, 2), np.float32)
_fn = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = backend.load_kernel_library("detect_corners")
        fn = lib.detect_corners_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def detect_corners_cuda(img: torch.Tensor, threshold: float, border: int = 16,
                        harris_k: float = HARRIS_K) -> torch.Tensor:
    """Launch the kernel on a contiguous (H, W) float32 CUDA tensor."""
    global LAUNCHES
    if not img.is_cuda:
        raise ValueError("detect_corners_cuda needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            f"expected a contiguous 2-D float32 image, got {img.dtype} "
            f"{tuple(img.shape)} contiguous={img.is_contiguous()}")
    H, W = img.shape
    if border < 4 or H <= 2 * border or W <= 2 * border:
        raise ValueError(f"border {border} must be >= 4 and leave an interior "
                         f"in a {H}x{W} image")
    fn = _kernel_fn()
    out = torch.empty_like(img)
    status = fn(
        img.data_ptr(), out.data_ptr(), H, W, float(threshold), float(harris_k),
        int(border), _TAPS.ctypes.data, torch.cuda.current_stream(img.device).cuda_stream,
    )
    backend.check_launch(status, "detect_corners_f32")
    LAUNCHES += 1
    return out


def detect_corners(img: torch.Tensor, threshold: float, border: int = 16) -> torch.Tensor:
    """Harris-ranked FAST corners with 3x3 NMS: (H, W) score map, -inf at
    non-keypoints. CPU tensor -> plain torch version; CUDA -> the kernel."""
    if img.is_cuda:
        return detect_corners_cuda(img.contiguous(), threshold, border)
    return detect_corners_plain(img, threshold=threshold, border=border)
