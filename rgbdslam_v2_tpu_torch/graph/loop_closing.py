"""Appearance-based global loop-closure retrieval over the stored nodes.

Port of ``rgbdslam_v2_tpu/graph/loop_closing.py`` (``global_match_scores``,
``global_match_scores_from_store``, ``retrieve_loop_candidates``; the
reference's loop_closing.cpp:190-278 getNeighbours). The node store's
descriptors are the index: every query descriptor is scored against every
stored one, and each node counts the query keypoints whose nearest stored
descriptor lies in it and passes the ratio test against the best match in
a different node.

Two routes compute the same (N,) int32 counts:

* ``global_match_scores_plain`` computes the (Kq, N*K) distance matrix over
  the whole capacity at once, as the JAX function does (600 x 614,400
  float32, 1.47 GB, at 1024 nodes of 600 keypoints). The tests and the
  chip smoke hold the other route to it.
* ``global_match_scores`` (the main path) computes only the columns of the
  first ``n_active`` rows (an inactive row's columns all read 1e9 and fill
  the top 8 only after every real column, so the counts do not change),
  in column chunks of at most ``CHUNK_BYTES``, and merges each chunk's top
  8 into the running top 8.

Ties break as ``lax.top_k``'s do, lowest column first: the top 8 is taken
over a unique int64 key ``(bits(dist) << 32) | column``, which orders as
(dist, column) because the bits of a non-negative float32 are monotone
(Hamming and squared L2 are both non-negative). The counts come from an
integer ``index_add_``, so they are the same on every run on the card.
No route synchronizes with the host.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.types import Keypoints
from ..ops.matching import BIG, descriptor_distances
from .node_store import NodeStore

TOP = 8  # the JAX function's k2: nearest stored descriptors kept a query
# bytes of a chunk's temporaries a query row and column: the float32 dot
# products and distances and the int64 key
BYTES_PER_ENTRY = 16
CHUNK_BYTES = 256 << 20


def _keys(q: Keypoints, desc: torch.Tensor, col_valid: torch.Tensor, col0: int) -> torch.Tensor:
    """The masked distances of query q to columns col0.. (desc, col_valid)
    as unique int64 keys (bits << 32) | column, which order as (dist,
    column). Adding 0.0 turns a -0.0 into +0.0, whose bits sort first."""
    dist = descriptor_distances(q.desc, desc)
    dist.masked_fill_(~(q.valid[:, None] & col_valid[None, :]), BIG).add_(0.0)
    keys = dist.view(torch.int32).to(torch.int64).bitwise_left_shift_(32)
    return keys.bitwise_or_(torch.arange(col0, col0 + desc.shape[0], device=desc.device,
                                         dtype=torch.int64))


def _counts(keys: torch.Tensor, q_valid: torch.Tensor, K: int, N: int,
            ratio: float) -> torch.Tensor:
    """Counts from each query row's ascending top keys (Kq, k2): the ratio
    test of the nearest against the nearest in another node."""
    dk = (keys >> 32).to(torch.int32).view(torch.float32)
    node_k = (keys & 0xFFFFFFFF) // K
    d1, nn_node = dk[:, 0], node_k[:, 0]
    d2 = torch.where(node_k != nn_node[:, None], dk, BIG).min(dim=1).values
    ok = (d1 < ratio * d2) & (d1 < BIG * 0.5) & q_valid
    return torch.zeros(N, dtype=torch.int32, device=keys.device).index_add_(
        0, nn_node, ok.to(torch.int32))


def global_match_scores_plain(kp: Keypoints, store: NodeStore, node_active: torch.Tensor,
                              exclude_mask: torch.Tensor, ratio: float = 0.8,
                              query_rows: int = 0) -> torch.Tensor:
    """The JAX function over the whole capacity, a (Kq, N*K) matrix (or
    query_rows rows of it at a time, which bounds its memory and changes
    nothing: each query row is scored alone): (N,) int32 counts.
    node_active, exclude_mask: (N,) bool."""
    N, K, D = store.desc.shape
    flat_valid = (store.kp_valid & node_active[:, None] & ~exclude_mask[:, None]).reshape(N * K)
    Kq = kp.desc.shape[0]
    step = query_rows or Kq
    top = torch.cat([
        torch.topk(_keys(Keypoints(*(f[r:r + step] for f in kp)), store.desc.reshape(N * K, D),
                         flat_valid, 0), min(TOP, N * K), dim=1, largest=False,
                   sorted=True).values
        for r in range(0, Kq, step)])
    return _counts(top, kp.valid, K, N, ratio)


def global_match_scores(kp: Keypoints, store: NodeStore, n_active: int,
                        exclude_mask: torch.Tensor, ratio: float = 0.8,
                        chunk_columns: int = 0) -> torch.Tensor:
    """The main path's route: the counts of global_match_scores_plain with
    node_active = the first n_active rows, computed over those rows only,
    in column chunks (chunk_columns, or as many as CHUNK_BYTES holds)."""
    N, K, D = store.desc.shape
    dev = store.desc.device
    n_cols = max(int(n_active), 0) * K
    if n_cols == 0:
        return torch.zeros(N, dtype=torch.int32, device=dev)
    Kq = kp.desc.shape[0]
    chunk = chunk_columns or max(TOP, CHUNK_BYTES // (BYTES_PER_ENTRY * Kq))
    flat_desc = store.desc[:n_active].reshape(n_cols, D)
    flat_valid = (store.kp_valid[:n_active] & ~exclude_mask[:n_active, None]).reshape(n_cols)
    best = None
    for c0 in range(0, n_cols, chunk):
        c1 = min(c0 + chunk, n_cols)
        keys = _keys(kp, flat_desc[c0:c1], flat_valid[c0:c1], c0)
        top = torch.topk(keys, min(TOP, c1 - c0), dim=1, largest=False, sorted=True).values
        if best is not None:
            top = torch.topk(torch.cat([best, top], dim=1), min(TOP, best.shape[1] + top.shape[1]),
                             dim=1, largest=False, sorted=True).values
        best = top
    return _counts(best, kp.valid, K, N, ratio)


def query_from_store(store: NodeStore, query_id: int) -> Keypoints:
    """A stored node's keypoints as a query (score, theta and level zero,
    as the JAX function builds them)."""
    valid = store.kp_valid[query_id]
    zeros = torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)
    return Keypoints(uv=store.uv[query_id], xyz=store.xyz[query_id], score=zeros,
                     theta=zeros, desc=store.desc[query_id], valid=valid,
                     level=torch.zeros(valid.shape, dtype=torch.int32, device=valid.device))


def exclude_window_mask(N: int, query_id: int, window: int, device) -> torch.Tensor:
    """(N,) bool: the nodes within `window` ids of the query (its sequential
    neighbours, not loop closures)."""
    ids = torch.arange(N, device=device)
    return (ids - query_id).abs() <= window


def global_match_scores_from_store(store: NodeStore, query_id: int, n_nodes: int,
                                   ratio: float = 0.8, exclude_window: int = 8,
                                   chunk_columns: int = 0) -> torch.Tensor:
    """global_match_scores with the query gathered from the store (node
    query_id, whose row the step has written) and the nodes within
    exclude_window of it masked: the keep-all path's deferred retrieval,
    one eager dispatch after a step call. (N,) int32 counts."""
    N = store.desc.shape[0]
    excl = exclude_window_mask(N, query_id, exclude_window, store.desc.device)
    return global_match_scores(query_from_store(store, query_id), store, n_nodes, excl, ratio,
                               chunk_columns)


def ranked_hits(counts: np.ndarray, out: List[int], new_id: int, n_global: int, B: int,
                min_hits: int) -> List[int]:
    """The keep-all path's hits from host counts (the JAX select_candidates'
    pipelined branch): by count, most first (numpy's argsort of -counts, as
    in JAX), at least min_hits votes, not yet in out nor new_id, at most
    n_global of them and no more than fill out to B."""
    hits = []
    for i in np.argsort(-counts):
        i = int(i)
        if counts[i] >= min_hits and i not in out and i != new_id:
            hits.append(i)
        if len(hits) >= n_global or len(out) + len(hits) >= B:
            break
    return hits


def retrieve_loop_candidates(kp: Keypoints, store: NodeStore, n_nodes: int, exclude_ids,
                             top_n: int = 4, min_votes: int = 10,
                             ratio: float = 0.8) -> List[int]:
    """Host wrapper (one device->host copy): the best-scoring node ids, most
    matched features first."""
    N = store.desc.shape[0]
    excl = np.zeros(N, bool)
    for i in exclude_ids:
        if 0 <= i < N:
            excl[i] = True
    excl_dev = torch.from_numpy(excl)
    if store.desc.is_cuda:  # from pinned memory: the copy does not synchronize
        excl_dev = excl_dev.pin_memory()
    excl_dev = excl_dev.to(store.desc.device, non_blocking=True)
    counts = global_match_scores(kp, store, n_nodes, excl_dev, ratio).cpu().numpy()
    order = np.argsort(-counts)
    return [int(i) for i in order[:top_n] if counts[i] >= min_votes]
