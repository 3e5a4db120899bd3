"""Stereo disparity -> depth by block matching.

Port of ``rgbdslam_v2_tpu/ops/stereo.py`` (``disparity_block_matching``,
``stereo_depth``; the reference's stereo input, stereoCallback,
src/openni_listener.cpp:559-598, consumes stereo_image_proc's block-matching
output). A rectified pair goes through zero-mean SAD block matching over a
(D, H, W) cost volume (D = max_disp shifts), winner-take-all with the first
minimum (``jnp.argmin``'s), a parabola subpixel step, a left-right check
read from the same volume (cost_R(x, d) = cost_L(x + d, d)), a
distinctness gate and the left border gate; invalid pixels get depth 0.

Torch ops (ROADMAP K9b: no hand-written kernel yet). The box sums add
block shifted slices of the zero-padded plane, rows then columns, and the
volume mean adds its planes in disparity order: every sum has one fixed
order of float32 additions, and every division has a tensor divisor, so the
card's volume is the CPU's bit for bit.
At 640x480 the volume is 64 x 480 x 640 float32, 78.6 MB.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sum(img: torch.Tensor, block: int) -> torch.Tensor:
    """(..., H, W) sums over block x block windows with zero padding, the
    output the input's size (``lax.reduce_window``'s 'same' sum)."""
    H, W = img.shape[-2:]
    r = block // 2
    pad = F.pad(img, (r, r, r, r))
    rows = pad[..., 0:H, :].clone()
    for dy in range(1, block):
        rows += pad[..., dy:dy + H, :]
    out = rows[..., :, 0:W].clone()
    for dx in range(1, block):
        out += rows[..., :, dx:dx + W]
    return out


def cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int = 64,
                block: int = 9) -> torch.Tensor:
    """(D, H, W) zero-mean SAD costs: cost(d, x) = box |lz(x) - rz(x - d)|,
    1e3 a pixel where x - d leaves the frame."""
    H, W = left.shape
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds otherwise than the CPU's division
    area = torch.tensor(float(block * block), device=left.device)
    lz = left - box_sum(left, block) / area
    rz = right - box_sum(right, block) / area
    diffs = torch.empty((max_disp, H, W), dtype=left.dtype, device=left.device)
    diffs[0] = (lz - rz).abs()
    for d in range(1, max_disp):
        diffs[d, :, d:] = (lz[:, d:] - rz[:, :W - d]).abs()
        diffs[d, :, :d] = 1e3
    return box_sum(diffs, block)


def disparity_block_matching(left: torch.Tensor, right: torch.Tensor, max_disp: int = 64,
                             block: int = 9):
    """Rectified grey pair (H, W) float32 -> (disparity (H, W) float32, valid
    (H, W) bool): WTA argmin, subpixel parabola, the LR check
    (|dL(x) - dR(x - dL)| <= 1), the distinctness gate (WTA cost below 0.75
    x the volume's mean), 0 < d < max_disp - 1 and x >= max_disp."""
    D = max_disp
    H, W = left.shape
    dev = left.device
    vol = cost_volume(left, right, max_disp, block)
    d0 = torch.argmin(vol, dim=0)  # the first minimum, as jnp.argmin

    def at(d):
        return torch.gather(vol, 0, d[None])[0]

    c0 = at(d0)
    cm = at(torch.clamp(d0 - 1, 0, D - 1))
    cp = at(torch.clamp(d0 + 1, 0, D - 1))
    denom = cm - 2.0 * c0 + cp
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (cm - cp) / torch.clamp(denom, min=1e-6), 0.0)
    disp = d0.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    # the right view's WTA from the same volume: cost_R(x, d) = cost_L(x + d, d)
    xs = torch.arange(W, device=dev)
    xl = torch.clamp(xs[None, :] + torch.arange(D, device=dev)[:, None], 0, W - 1)
    d0_r = torch.argmin(torch.gather(vol, 2, xl[:, None, :].expand(D, H, W)), dim=0)
    d_back = torch.gather(d0_r, 1, torch.clamp(xs[None, :] - d0, 0, W - 1))
    lr_ok = (d0 - d_back).abs() <= 1

    total = vol[0].clone()
    for d in range(1, D):
        total += vol[d]
    distinct = c0 < 0.75 * (total / torch.tensor(float(D), device=dev))
    valid = lr_ok & distinct & (d0 > 0) & (d0 < D - 1) & (xs[None, :] >= D)
    return disp, valid


def stereo_depth(left: torch.Tensor, right: torch.Tensor, fx: float, baseline: float,
                 max_disp: int = 64, block: int = 9):
    """Rectified grey pair -> (depth (H, W) float32 metres, valid (H, W)
    bool): depth = fx * baseline / disparity, 0 where invalid (every input
    modality's missing-depth convention)."""
    disp, valid = disparity_block_matching(left, right, max_disp, block)
    depth = (fx * baseline) / torch.clamp(disp, min=0.5)
    return torch.where(valid & (disp > 0.5), depth, 0.0), valid
