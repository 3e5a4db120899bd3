"""Sharded SLAM work: the candidate fan-out and the pose-graph LM over a
mesh.

Port of ``rgbdslam_v2_tpu/parallel/sharded.py`` (``sharded_compare``,
``sharded_lm_iteration``, ``sharded_optimize``). The JAX package runs each
as one shard_map program; here each shard's work is queued on its device
in turn and the results meet on the mesh's first device.

1. sharded_compare: the frontend's loop-closure candidate fan-out
   (QtConcurrent::blockingMapped over candidate nodes,
   graph_manager.cpp:548). The candidates split into contiguous shards;
   each shard compares the new frame against its candidates on its device
   with a generator of its own, and the results are concatenated.
2. sharded_lm_iteration: the backend's normal-equation assembly (the g2o
   solve, graph_manager.cpp:998). The edges split into contiguous shards
   with the poses replicated; the shards' chi2, gradient, block diagonal
   and Hessian-vector partials are summed on the first device (the psum)
   and the PCG loop runs once there, where JAX runs it replicated on every
   device: the same result.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List

import numpy as np
import torch

from ..core import se3
from ..graph.compare import CompareResult, compare_to_candidates
from ..graph.node_store import NodeStore
from ..optim.pose_graph import (GraphState, _build_gradient_and_diag, _chol_6, _chol_apply,
                                _edge_terms, _hessian_matvec, _pcg, edge_chi2)
from .mesh import DeviceMesh, on_device


# ----------------------------------------------------------------------
# 1. candidate fan-out
# ----------------------------------------------------------------------
def shard_generators(generator: torch.Generator, devices) -> List[torch.Generator]:
    """One generator per shard, seeded from the caller's (the counterpart
    of jax.random.split(key, n)): shard k's seed is the k-th of n 63-bit
    integers drawn by numpy's default_rng seeded with the SHA-256 digest of
    the caller's generator state. The caller's generator then advances by
    one draw, so the next call derives other seeds. Reading the state
    does not wait for the card."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()).digest()
    seeds = np.random.default_rng(list(digest)).integers(0, 2**63 - 1, size=len(devices))
    torch.empty(1, device=generator.device).uniform_(generator=generator)
    out = []
    for dev, seed in zip(devices, seeds):
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        out.append(g)
    return out


def _on(kp, dev):
    """Keypoints (a NamedTuple of tensors) on `dev`."""
    return type(kp)(*(t.to(dev) for t in kp))


def _store_rows(store: NodeStore, idx: torch.Tensor, dev) -> NodeStore:
    """The rows `idx` of the store, as a store of their own on `dev`."""
    return NodeStore(*(getattr(store, f.name)[idx].to(dev)
                       for f in dataclasses.fields(NodeStore)))


def sharded_compare(mesh: DeviceMesh, new_kp, new_depth_small: torch.Tensor, store: NodeStore,
                    cand_idx: torch.Tensor, generator: torch.Generator, cam_small,
                    **kw) -> CompareResult:
    """compare_to_candidates with the candidate axis split into mesh.size
    contiguous shards (B must divide by it), shard k on mesh.devices[k]
    with shard_generators' k-th generator. The store is replicated: a
    shard on the store's own device reads it in place, another gets a copy
    of its candidates' rows (all that a comparison reads). The results are
    concatenated on the mesh's first device."""
    n = mesh.size
    B = cand_idx.shape[0]
    if B % n:
        raise ValueError(f"{B} candidates not divisible by {n} devices")
    gens = shard_generators(generator, mesh.devices)
    home = store.uv.device
    parts = []
    for (dev, lo, hi), gen in zip(mesh.blocks(B), gens):
        idx = cand_idx[lo:hi]
        if dev == home:
            st, ci = store, idx
        else:
            st = _store_rows(store, idx, dev)
            ci = torch.arange(hi - lo, device=dev)
        with on_device(dev):
            parts.append(compare_to_candidates(_on(new_kp, dev), new_depth_small.to(dev), st, ci,
                                               gen, cam_small, **kw))
    first = mesh.devices[0]
    return CompareResult(*(None if parts[0][k] is None
                           else torch.cat([p[k].to(first) for p in parts])
                           for k in range(len(CompareResult._fields))))


# ----------------------------------------------------------------------
# 2. distributed pose-graph LM
# ----------------------------------------------------------------------
def _edge_shards(mesh: DeviceMesh, g: GraphState) -> List[GraphState]:
    """Contiguous edge shards, each on its device with the poses and
    masks replicated."""
    E = g.edge_i.shape[0]
    bounds = np.linspace(0, E, mesh.size + 1).astype(int)
    out = []
    for dev, lo, hi in zip(mesh.devices, bounds[:-1], bounds[1:]):
        out.append(GraphState(
            poses=g.poses.to(dev), node_active=g.node_active.to(dev),
            node_fixed=g.node_fixed.to(dev), edge_i=g.edge_i[lo:hi].to(dev),
            edge_j=g.edge_j[lo:hi].to(dev), edge_meas=g.edge_meas[lo:hi].to(dev),
            edge_info=g.edge_info[lo:hi].to(dev), edge_active=g.edge_active[lo:hi].to(dev)))
    return out


def sharded_lm_iteration(mesh: DeviceMesh, g: GraphState, lam: torch.Tensor,
                         huber_delta: float = 1.0, pcg_iters: int = 32):
    """One PCG LM iteration with the edges sharded over the mesh. Returns
    (new_poses, new_lam, chi2_before, chi2_after) on the mesh's first
    device, as optim.pose_graph.lm_iteration does."""
    first = mesh.devices[0]
    shards = _edge_shards(mesh, g)
    terms = [_edge_terms(gs, huber_delta) for gs in shards]  # (r, Ji, info_w, chi2_e)

    def psum(parts):
        return sum(x.to(first) for x in parts)

    chi2 = psum([torch.where(gs.edge_active, t[3], 0.0).sum() for gs, t in zip(shards, terms)])
    partial = [_build_gradient_and_diag(gs, t[0], t[1], t[2]) for gs, t in zip(shards, terms)]
    b, Hdiag = psum([x[0] for x in partial]), psum([x[1] for x in partial])
    poses = g.poses.to(first)
    free = (g.node_active & ~g.node_fixed).to(first).to(b.dtype)
    frees = [free.to(gs.poses.device) for gs in shards]
    lam = lam.to(first)
    lam_diag = lam * torch.einsum("nii->n", Hdiag)[:, None] / 6.0 + lam * 1e-3 + 1e-8
    eye6 = torch.eye(6, dtype=b.dtype, device=first)
    L = _chol_6(Hdiag + (lam_diag[:, :, None] + (1.0 - free)[:, None, None]) * eye6)

    def matvec(v):
        hv = psum([_hessian_matvec(gs, t[1], t[2], fr, 0.0, v.to(gs.poses.device))
                   for gs, t, fr in zip(shards, terms, frees)])
        return (hv + lam_diag * v) * free[:, None]

    delta = _pcg(matvec, lambda v: _chol_apply(L, v) * free[:, None], -b * free[:, None],
                 pcg_iters)
    new_poses = poses @ se3.exp_se3(delta)
    chi2_new = psum([edge_chi2(dataclasses.replace(gs, poses=new_poses.to(gs.poses.device))).sum()
                     for gs in shards])
    improved = chi2_new < chi2
    poses_out = torch.where(improved, new_poses, poses)
    lam_out = torch.where(improved, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
    return poses_out, lam_out, chi2, torch.where(improved, chi2_new, chi2)


def sharded_optimize(mesh: DeviceMesh, g: GraphState, iterations: int = 15,
                     huber_delta: float = 1.0, pcg_iters: int = 32):
    """Host loop over sharded LM iterations, stopping where an iteration
    improves chi2 by less than 1e-4 relative. Returns (state with the new
    poses, chi2 tensor)."""
    lam = torch.full((), 1e-4, device=mesh.devices[0])
    chi2 = None
    for _ in range(iterations):
        poses, lam, chi2_before, chi2 = sharded_lm_iteration(mesh, g, lam, huber_delta,
                                                             pcg_iters)
        g = dataclasses.replace(g, poses=poses)
        before, after = float(chi2_before), float(chi2)
        if before > 0 and (before - after) / before < 1e-4:
            break
    return g, chi2
