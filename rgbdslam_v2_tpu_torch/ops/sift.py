"""SIFT: Gaussian scale space, DoG extrema, oriented 128-D descriptors.

Port of ``rgbdslam_v2_tpu/ops/sift.py``: ``scale_space``, ``dog_extrema``,
``gradients``, ``keypoint_orientation_sift``, ``sift_descriptors`` and
``root_sift``.

The JAX version builds both histograms with scatter-adds
(``.at[k, bin].add``), which XLA runs in index order on the CPU. Floating
scatter-adds on the card are atomic, so their order, and the sums' last
bits, would change from run to run: a CUDA-graph replay could then not
equal an eager step, nor a run its continuation from a checkpoint. Here
each histogram is a fixed-order reduction of one-hot weights:

* orientation: ``(K, 289 samples, 36 bins)``, summed over the samples;
* descriptor: the 256 samples regrouped by their static 4x4 cell
  (``CELL_ORDER``) into ``(K, 16 cells, 16 samples, 8 bins)``, summed over
  the cell's samples.

The sums group the terms differently from the JAX version's sequential
scatter, so histogram values differ from it by float32 rounding
(``tests/test_torch_sift.py`` states the bounds).

The orientation and descriptor functions also take a stack of scale
planes with each keypoint's plane, so ``models/sift.py`` describes every
keypoint at its own scale in one call (the per-scale constants gathered
per keypoint); the arithmetic per keypoint is the JAX version's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import backend
from .image import bilinear_sample, gaussian_blur, maxpool2d_same

N_SPATIAL = 4  # descriptor grid (4x4)
N_ORI = 8  # orientation bins per cell
DESC_DIM = N_SPATIAL * N_SPATIAL * N_ORI  # 128
N_HIST = 36  # orientation-assignment histogram bins
ORI_R = 8  # orientation window radius, pixels at the keypoint's scale
G = 4 * N_SPATIAL  # descriptor samples per side (16)


def scale_space(img: torch.Tensor, n_scales: int = 3, sigma0: float = 1.6):
    """One octave's Gaussian stack: (n_scales + 3, H, W) and its sigmas."""
    k = 2.0 ** (1.0 / n_scales)
    sigmas = [sigma0 * (k**i) for i in range(n_scales + 3)]
    gs = [gaussian_blur(img, sigmas[0])]
    for i in range(1, n_scales + 3):
        # incremental blur: sigma_inc^2 = s_i^2 - s_{i-1}^2
        inc = math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-6))
        gs.append(gaussian_blur(gs[-1], inc))
    return torch.stack(gs), np.asarray(sigmas, np.float32)


def _hessian_ok(d: torch.Tensor, edge_ratio: float) -> torch.Tensor:
    """2x2 spatial Hessian trace/det test of (S, H, W) DoG planes."""
    def roll(t, sy, sx):
        return torch.roll(t, (sy, sx), (-2, -1))

    dxx = roll(d, 0, -1) + roll(d, 0, 1) - 2 * d
    dyy = roll(d, -1, 0) + roll(d, 1, 0) - 2 * d
    dxy = 0.25 * (roll(d, -1, -1) + roll(d, 1, 1) - roll(d, -1, 1) - roll(d, 1, -1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    return (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)


def dog_extrema(dogs: torch.Tensor, contrast_threshold: float = 0.015,
                edge_ratio: float = 10.0, border: int = 8) -> torch.Tensor:
    """Dense extrema over the DoG volume (S, H, W) -> score map (S-2, H, W):
    |DoG| at 3x3x3 extrema that pass the contrast and edge tests, -inf
    elsewhere and within `border` pixels of the edge."""
    S, H, W = dogs.shape
    sp_max = maxpool2d_same(dogs, 3)  # 3x3 spatial max of every scale
    sp_min = -maxpool2d_same(-dogs, 3)
    center = dogs[1:-1]
    is_max = (center >= sp_max[1:-1]) & (center >= sp_max[:-2]) & (center >= sp_max[2:])
    is_min = (center <= sp_min[1:-1]) & (center <= sp_min[:-2]) & (center <= sp_min[2:])
    extremum = (is_max | is_min) & (torch.abs(center) > contrast_threshold)
    score = torch.where(extremum & _hessian_ok(center, edge_ratio), torch.abs(center),
                        float("-inf"))
    yy = torch.arange(H, device=dogs.device)[:, None]
    xx = torch.arange(W, device=dogs.device)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    return torch.where(inb, score, float("-inf"))


def gradients(img: torch.Tensor):
    """Central-difference gradient magnitude and angle of (..., H, W)
    images (wrapping at the borders, as the JAX version's rolls do)."""
    dx = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    dy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    mag = torch.sqrt(dx * dx + dy * dy + 1e-12)
    ang = torch.atan2(dy, dx)
    return mag, ang


# ---- static sample layouts ----
_oy, _ox = np.mgrid[-ORI_R : ORI_R + 1, -ORI_R : ORI_R + 1]
ORI_OFFS = np.stack([_ox.ravel(), _oy.ravel()], -1).astype(np.float32)  # (289, 2)
_gy, _gx = np.mgrid[0:G, 0:G]
DESC_CELL = ((_gy // 4) * N_SPATIAL + _gx // 4).ravel()  # (256,) cell of each sample
# the samples regrouped cell by cell, in sample order within a cell
CELL_ORDER = np.argsort(DESC_CELL, kind="stable").reshape(N_SPATIAL * N_SPATIAL, 16)


def orientation_window(sigma: float) -> np.ndarray:
    """(289,) Gaussian weights of the orientation window at one scale."""
    return np.exp(-(_ox**2 + _oy**2) / (2.0 * (1.5 * sigma) ** 2)).astype(np.float32).ravel()


def descriptor_grid(scale: float):
    """(256,) x offsets, (256,) y offsets and (256,) Gaussian weights of
    the 16x16 descriptor samples at one scale, in the JAX version's
    float32 values."""
    step = 0.75 * scale
    gx = (_gx - (G - 1) / 2.0) * step
    gy = (_gy - (G - 1) / 2.0) * step
    w = np.exp(-(gx**2 + gy**2) / (2.0 * (0.5 * G * step) ** 2)).astype(np.float32)
    return (gx.ravel().astype(np.float32), gy.ravel().astype(np.float32), w.ravel())


def _per_keypoint(table_fn, scale, plane, key, dev):
    """A static table at one scale as (1, ...), or, with `plane` the (K,)
    scale index of each keypoint and `scale` the tuple of the planes'
    scales, the row of each keypoint's own scale: (K, ...)."""
    if plane is None:
        return backend.constant((key, float(scale)), lambda: table_fn(float(scale))[None], dev)
    return backend.constant((key, tuple(scale)), lambda: np.stack(
        [table_fn(float(s)) for s in scale]), dev)[plane]


def keypoint_orientation_sift(mag: torch.Tensor, ang: torch.Tensor, uv: torch.Tensor,
                              sigma, plane: torch.Tensor | None = None) -> torch.Tensor:
    """Dominant gradient orientation per keypoint (36-bin histogram peak).

    mag/ang: (H, W) at the keypoint's scale `sigma`; or (S, H, W) with
    `sigma` the tuple of the S planes' scales and `plane` the (K,) plane of
    each keypoint. uv: (K, 2)."""
    dev = uv.device
    K = uv.shape[0]
    wg = _per_keypoint(orientation_window, sigma, plane, "sift_ori_w", dev)
    offs = backend.constant("sift_ori_offs", lambda: ORI_OFFS, dev)
    x = uv[:, 0:1] + offs[None, :, 0]
    y = uv[:, 1:2] + offs[None, :, 1]
    pl = None if plane is None else plane[:, None]
    m = bilinear_sample(mag, x, y, pl) * wg
    a = bilinear_sample(ang, x, y, pl)
    bin_f = (a + np.pi) * (N_HIST / (2 * np.pi))
    fl = torch.floor(bin_f)
    b0 = torch.remainder(fl.long(), N_HIST)
    b1 = torch.remainder(b0 + 1, N_HIST)
    f = bin_f - fl
    bins = torch.arange(N_HIST, device=dev)
    w0 = torch.where(b0[..., None] == bins, (m * (1 - f))[..., None], 0.0)
    w1 = torch.where(b1[..., None] == bins, (m * f)[..., None], 0.0)
    hist = w0.sum(1) + w1.sum(1)  # (K, 36), a fixed-order reduction
    for _ in range(2):  # smooth the circular histogram twice
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    hp = torch.gather(hist, 1, torch.remainder(peak + 1, N_HIST)[:, None])[:, 0]
    hm = torch.gather(hist, 1, torch.remainder(peak - 1, N_HIST)[:, None])[:, 0]
    h0 = torch.gather(hist, 1, peak[:, None])[:, 0]
    denom = hm - 2 * h0 + hp
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (hm - hp) / denom, 0.0)
    theta = (peak.float() + delta + 0.5) * (2 * np.pi / N_HIST) - np.pi
    return theta.reshape(K)


def sift_descriptors(mag: torch.Tensor, ang: torch.Tensor, uv: torch.Tensor,
                     theta: torch.Tensor, scale,
                     plane: torch.Tensor | None = None) -> torch.Tensor:
    """4x4x8 gradient-histogram descriptors, (K, 128) float32, normalized
    (L2, clip 0.2, L2). A 16x16 grid rotated by theta, spaced 0.75 *
    scale pixels, Gaussian-weighted, soft orientation and hard spatial
    binning. `scale`/`plane` as `sigma`/`plane` of
    keypoint_orientation_sift."""
    dev = uv.device
    K = uv.shape[0]
    grid = _per_keypoint(lambda s: np.stack(descriptor_grid(s)), scale, plane,
                         "sift_desc_grid", dev)
    offs_x, offs_y, wg = grid[:, 0], grid[:, 1], grid[:, 2]
    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    rx = c * offs_x - s * offs_y
    ry = s * offs_x + c * offs_y
    x = uv[:, 0:1] + rx
    y = uv[:, 1:2] + ry
    pl = None if plane is None else plane[:, None]
    m = bilinear_sample(mag, x, y, pl) * wg
    a = bilinear_sample(ang, x, y, pl) - theta[:, None]
    bin_f = (a + 4 * np.pi) * (N_ORI / (2 * np.pi))
    fl = torch.floor(bin_f)
    b0 = torch.remainder(fl.long(), N_ORI)
    b1 = torch.remainder(b0 + 1, N_ORI)
    f = bin_f - fl
    order = backend.constant("sift_cell_order", lambda: CELL_ORDER, dev)  # (16, 16)
    bins = torch.arange(N_ORI, device=dev)
    w0 = torch.where(b0[:, order, None] == bins, (m * (1 - f))[:, order, None], 0.0)
    w1 = torch.where(b1[:, order, None] == bins, (m * f)[:, order, None], 0.0)
    desc = (w0.sum(2) + w1.sum(2)).reshape(K, DESC_DIM)  # (K, 16 cells x 8 bins)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-9)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-9)
    return desc


def root_sift(desc: torch.Tensor) -> torch.Tensor:
    """RootSIFT (squareroot_descriptor_space): L1-normalize, then sqrt; L2
    distance then approximates the Hellinger distance."""
    l1 = torch.sum(torch.abs(desc), dim=-1, keepdim=True) + 1e-9
    return torch.sqrt(desc / l1)
