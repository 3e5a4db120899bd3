"""Descriptor matching: Hamming distances, knn2 ratio test, dedup, top-M.

Port of ``rgbdslam_v2_tpu/ops/matching.py`` (``descriptor_distances``,
``match_descriptors``), batched over a leading candidate dimension (the
JAX version is vmapped).

Distances dispatch on the descriptor dtype, as in the JAX version:

* int8 +/-1 (ORB, BRIEF, BRISK, FREAK): Hamming(a, b) = (D - a.b) / 2. The
  dot product is a float32 matmul of +/-1 values: 256 or 512 terms of +/-1
  sum exactly in float32, and CUDA has no general int8 matmul in torch.
* float (SIFT's float32, and the bf16 / float32 binary stores of
  ``tpu_descriptor_dtype``): squared L2, max(a2 + b2 - 2 a.b, 0). The
  products are computed in float32 (a bf16 store is widened first, so a
  cuBLAS bf16 reduction never rounds a partial sum; TF32 stays off, ROADMAP
  F4). For +/-1 values this is exactly 4 x Hamming, so the ratio test, the
  dedup and the top-M pick the same matches as the int8 store.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .fast import topk_stable

BIG = 1e9


class Matches(NamedTuple):
    """(B, M) match sets: query/train indices, distance, validity."""

    src_idx: torch.Tensor
    dst_idx: torch.Tensor
    dist: torch.Tensor
    valid: torch.Tensor


def descriptor_distances(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., Ka, D) x (..., Kb, D) -> (..., Ka, Kb): Hamming for int8 +/-1
    descriptors, squared L2 for float ones."""
    a = desc_a.float()
    b = desc_b.float()
    dot = a @ b.transpose(-1, -2)
    if desc_a.dtype == torch.int8:
        return (desc_a.shape[-1] - dot) * 0.5
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1)
    return torch.clamp(a2 + b2[..., None, :] - 2.0 * dot, min=0.0)


def match_descriptors(desc_a: torch.Tensor, valid_a: torch.Tensor,
                      desc_b: torch.Tensor, valid_b: torch.Tensor,
                      max_matches: int, ratio: float = 0.95) -> Matches:
    """Query set a (Ka, D) against B train sets b (B, Kb, D)."""
    Ka = desc_a.shape[0]
    B, Kb = desc_b.shape[:2]
    dev = desc_a.device
    max_matches = min(max_matches, Ka)
    dist = descriptor_distances(desc_a, desc_b)  # (B, Ka, Kb)
    dist = torch.where(valid_a[None, :, None] & valid_b[:, None, :], dist, BIG)
    d1, nn = dist.min(dim=-1)  # first minimum, like argmin
    cols = torch.arange(Kb, device=dev)
    d2 = torch.where(cols[None, None, :] == nn[..., None], BIG, dist).min(dim=-1).values
    ok = (d1 < ratio * d2) & (d1 < BIG * 0.5) & valid_a[None, :]
    passing = torch.where(ok, d1, BIG)
    best_for_train = torch.full((B, Kb), BIG, device=dev).scatter_reduce(
        1, nn, passing, reduce="amin", include_self=True)
    is_best = passing <= torch.gather(best_for_train, 1, nn)
    q = torch.arange(Ka, device=dev).expand(B, Ka)
    first_q = torch.full((B, Kb), Ka, device=dev, dtype=torch.long).scatter_reduce(
        1, nn, torch.where(is_best & ok, q, Ka), reduce="amin", include_self=True)
    keep = ok & is_best & (torch.gather(first_q, 1, nn) == q)
    sel_cost = torch.where(keep, d1, BIG)
    neg_top, src_idx = topk_stable(-sel_cost, max_matches)
    d_sel = -neg_top
    m_valid = d_sel < BIG * 0.5
    dst_idx = torch.gather(nn, 1, src_idx)
    return Matches(
        src_idx=torch.where(m_valid, src_idx, 0),
        dst_idx=torch.where(m_valid, dst_idx, 0),
        dist=torch.where(m_valid, d_sel, 0.0),
        valid=m_valid,
    )
