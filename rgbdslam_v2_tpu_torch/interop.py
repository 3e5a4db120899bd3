"""Numpy <-> port state, so state built elsewhere (for example by the JAX
package, via ``np.asarray`` of each leaf) can be carried into the port and
back.

* ``NodeStore``: the packed EMM pools are uint32 in numpy (the JAX dtype)
  and int32 with the same bits in the port; the JAX store's ``emm_zs``
  plane has no counterpart and is dropped.
* ``GraphState``, ``Keypoints``: field by field, dtypes unchanged.
* ``SyntheticWorld``: textures, boxes, extent.
* A checkpoint the JAX package's ``GraphManager.save_state`` wrote: its
  arrays are numbered leaves, ``store_i`` and ``graph_i``, in the order of
  the JAX NamedTuples' fields (``graph/node_store.py`` ``NodeStore``,
  ``optim/pose_graph.py`` ``GraphState``), written down here as
  ``JAX_STORE_FIELDS`` and ``JAX_GRAPH_FIELDS``. ``emm_zs`` is leaf 6, so
  the later store leaves sit one index above the port's field positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .graph.node_store import NodeStore
from .io.synthetic import SyntheticWorld
from .models.types import Keypoints
from .optim.pose_graph import GraphState


# the JAX NamedTuples' field orders (= their leaf order in a checkpoint)
JAX_STORE_FIELDS = ("uv", "xyz", "desc", "kp_valid", "depth", "emm_lohi", "emm_zs", "color")
JAX_GRAPH_FIELDS = ("poses", "node_active", "node_fixed", "edge_i", "edge_j", "edge_meas",
                    "edge_info", "edge_active")


def jax_checkpoint_arrays(data) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The numbered leaves of a JAX checkpoint (a mapping such as an
    ``np.load`` of it) -> (store arrays, graph arrays) by field name; the
    store's still hold emm_zs and uint32 pools (store_from_numpy drops and
    reinterprets them)."""
    store = {name: np.asarray(data[f"store_{i}"]) for i, name in enumerate(JAX_STORE_FIELDS)}
    graph = {name: np.asarray(data[f"graph_{i}"]) for i, name in enumerate(JAX_GRAPH_FIELDS)}
    return store, graph


def _fields(obj) -> Dict[str, Any]:
    if isinstance(obj, Mapping):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    raise TypeError(f"cannot read fields of {type(obj).__name__}")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(state) -> Dict[str, np.ndarray]:
    """Port state (NodeStore, GraphState, Keypoints) -> numpy arrays."""
    out = {k: v.detach().cpu().numpy() for k, v in _fields(state).items()}
    if isinstance(state, NodeStore):
        out["emm_lohi"] = out["emm_lohi"].view(np.uint32)
    return out


def graph_from_numpy(arrays, device=None) -> GraphState:
    f = _fields(arrays)
    return GraphState(**{k.name: _tensor(f[k.name], device)
                         for k in dataclasses.fields(GraphState)})


def store_from_numpy(arrays, device=None) -> NodeStore:
    f = _fields(arrays)
    vals = {k.name: np.asarray(f[k.name]) for k in dataclasses.fields(NodeStore)}
    vals["emm_lohi"] = vals["emm_lohi"].astype(np.uint32).view(np.int32)
    return NodeStore(**{k: _tensor(v, device) for k, v in vals.items()})


def keypoints_from_numpy(arrays, device=None) -> Keypoints:
    f = _fields(arrays)
    return Keypoints(**{k: _tensor(f[k], device) for k in Keypoints._fields})


def world_to_numpy(world) -> Dict[str, Any]:
    return {"textures": np.asarray(world.textures, np.float32),
            "boxes": tuple(world.boxes), "extent": tuple(world.extent)}


def world_from_numpy(textures, boxes, extent, cam) -> SyntheticWorld:
    return SyntheticWorld(extent=tuple(float(x) for x in extent),
                          textures=np.array(textures, np.float32),
                          boxes=tuple(boxes), cam=cam)
