"""Empirical edge information from residual statistics.

Port of ``rgbdslam_v2_tpu/optim/covariance.py`` (``empirical_information``;
the reference's setEmpiricalCovariances, src/graph_manager2.cpp:111-144,
src/covariance_estimation.cpp:41-77). Each active edge's covariance is a
kernel-weighted mean of the outer products of the residuals of similar
edges (similar in measured translation and rotation magnitude), inverted
into its new information matrix.

The JAX function builds the (E, E) weights at once; here they are built in
row chunks of ``ROW_CHUNK`` edges, each a (chunk, E) block, and the weighted
sum is one matmul against the (E, 36) outer products. The inverses are
``torch.linalg.inv_ex``, which does not synchronize with the host.
Inactive slots keep their information bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import se3
from .pose_graph import GraphState

ROW_CHUNK = 1024


def empirical_information(g: GraphState, bandwidth: float = 0.1, min_info: float = 1.0,
                          max_info: float = 1e6, n_edges: Optional[int] = None) -> torch.Tensor:
    """New (E, 6, 6) information matrices. n_edges: the used edge slots
    (every slot above holds an inactive edge), by default all."""
    m = g.edge_i.shape[0] if n_edges is None else n_edges
    meas = g.edge_meas[:m]
    Xi = g.poses[g.edge_i[:m].long()]
    Xj = g.poses[g.edge_j[:m].long()]
    r = se3.log_se3(se3.inv(meas) @ se3.inv(Xi) @ Xj)  # (m, 6)
    act = g.edge_active[:m].float()
    # edge descriptors: measurement magnitudes (translation, rotation)
    feat = torch.stack([se3.translation_norm(meas), se3.rotation_angle(meas)], -1)
    outer = (r[:, :, None] * r[:, None, :]).reshape(m, 36)
    cov = torch.empty((m, 36), dtype=r.dtype, device=r.device)
    for e0 in range(0, m, ROW_CHUNK):
        f = feat[e0:e0 + ROW_CHUNK]
        d2 = torch.sum((f[:, None, :] - feat[None, :, :]) ** 2, -1)
        w = torch.exp(-d2 / (2.0 * bandwidth * bandwidth)) * act[None, :]
        wsum = torch.sum(w, -1, keepdim=True) + 1e-9
        cov[e0:e0 + ROW_CHUNK] = (w / wsum) @ outer
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    info = torch.linalg.inv_ex(cov.view(m, 6, 6) + eye * 1e-8).inverse
    # symmetrize, then scale to a bounded mean diagonal keeping the structure
    info = 0.5 * (info + info.transpose(-1, -2))
    tr6 = torch.diagonal(info, dim1=-2, dim2=-1).sum(-1) / 6.0
    scale = torch.clamp(tr6, min_info, max_info) / (tr6 + 1e-12)
    info = info * scale[:, None, None]
    out = g.edge_info.clone()
    out[:m] = torch.where(act[:, None, None] > 0, info, g.edge_info[:m])
    return out
