"""Dense image ops on (H, W) float32 tensors.

Port of ``rgbdslam_v2_tpu/ops/image.py``: ``gaussian_kernel_1d``,
``_conv1d`` (shift-and-add with reflect padding, same operation order),
``gaussian_blur``, ``sobel``, ``harris_response``, ``maxpool2d_same``,
``resize_bilinear`` and ``bilinear_sample``.

``resize_bilinear`` reproduces ``jax.image.resize(method="bilinear")``,
which antialiases when it downsamples (a triangle kernel stretched by the
scale): the same weight matrices are built in numpy and applied as
``Wy^T @ img @ Wx``. ``F.interpolate`` uses a different kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import backend


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """Separable correlation along one axis, reflect-padded; the terms are
    summed in tap order (float32 rounding identical to the JAX version)."""
    k = np.asarray(k, np.float32)
    r = len(k) // 2
    H, W = img.shape
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    x = F.pad(img[None, None], pad, mode="reflect")[0, 0]
    out = None
    for i, w in enumerate(k.tolist()):
        term = (x[i : i + H, :] if axis == 0 else x[:, i : i + W]) * w
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None):
    k = gaussian_kernel_1d(sigma, radius)
    return _conv1d(_conv1d(img, k, 0), k, 1)


_SMOOTH = np.asarray([1.0, 2.0, 1.0], np.float32)
_DIFF = np.asarray([-1.0, 0.0, 1.0], np.float32)


def sobel(img: torch.Tensor):
    gx = _conv1d(_conv1d(img, _SMOOTH, 0), _DIFF, 1)
    gy = _conv1d(_conv1d(img, _DIFF, 0), _SMOOTH, 1)
    return gx, gy


def maxpool2d_same(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Max over a size x size window (-inf outside) of each (H, W) plane of
    img (..., H, W), same shape."""
    r = size // 2
    H, W = img.shape[-2:]
    out = F.max_pool2d(img.reshape(-1, 1, H, W), size, stride=1, padding=r)
    return out.reshape(img.shape)


def harris_response(img: torch.Tensor, k: float = 0.04, window_sigma: float = 1.5):
    gx, gy = sobel(img)
    Ixx = gaussian_blur(gx * gx, window_sigma, radius=2)
    Iyy = gaussian_blur(gy * gy, window_sigma, radius=2)
    Ixy = gaussian_blur(gx * gy, window_sigma, radius=2)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax.image.resize's bilinear
    (triangle) kernel with antialiasing, same float32 arithmetic. XLA
    contracts the sample position (i + 0.5) * inv_scale - 0.5 into one
    fused multiply-add; the product is exact in float64, so rounding the
    float64 result once reproduces it (a separately rounded product moves
    a position by one float32 ulp, a weight by up to ~3e-5)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    pos = (np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (pos * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, shape, out: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) -> shape, as jax.image.resize(img, shape, "bilinear"). `out`, an
    (h, w) tensor with unit column stride, receives the last product in place
    (its rows may be padded)."""
    H, W = img.shape
    h, w = shape
    res = img
    if h != H:
        wy = backend.constant(("resize", H, h), lambda: resize_weights(H, h), img.device)
        res = torch.mm(wy.T, res, out=out if w == W else None)
    if w != W:
        wx = backend.constant(("resize", W, w), lambda: resize_weights(W, w), img.device)
        res = torch.mm(res, wx, out=out)
    if out is None:
        return res
    if res is img:
        out.copy_(img)
    return out


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    plane: torch.Tensor | None = None) -> torch.Tensor:
    """Sample an (H, W) image at float coordinates x (columns), y (rows),
    clamped to [0, W - 1.001] x [0, H - 1.001], in the JAX version's order of
    operations. With `plane` (a long tensor broadcastable to x), img is an
    (S, H, W) stack and each sample reads its own plane."""
    H, W = img.shape[-2:]
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    base = y0 * W + x0
    if plane is not None:
        base = base + plane * (H * W)
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + W]
    v11 = flat[base + W + 1]
    return (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)
