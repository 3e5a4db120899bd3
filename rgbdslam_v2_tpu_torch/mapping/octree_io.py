"""OctoMap .ot (ColorOcTree) serialization — host-side writer + reader.

Port of ``rgbdslam_v2_tpu/mapping/octree_io.py``, host numpy as there, and
byte for byte the same writer. The reference saves colored octomaps via
octomap::ColorOcTree::write (reference: src/ColorOctomapServer.cpp:38-50,
graph_mgr_io.cpp:253-310). Format (octomap 1.8 'OcTree file' container):

    # Octomap OcTree file
    # (other comment lines)
    id ColorOcTree
    size <node count>
    res <leaf resolution>
    data
    <binary pre-order node stream>

Node stream (pre-order depth-first, octomap OcTreeBaseImpl::writeNodesRecurs):
each node serializes its payload, then ONE byte whose bit i marks that child
i exists (and is then recursively serialized). The child index follows
octomap computeChildIdx: bit 0 from the x key bit, bit 1 from y, bit 2 from
z at the node's depth. ColorOcTreeNode payload = float32 log-odds
(little-endian) + 3 bytes RGB (ColorOcTreeNode::writeData).

A matching reader is provided for round-trip tests and for loading .ot maps
back into voxel lists.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

TREE_DEPTH = 16  # octomap's fixed maximum depth


def _keys_from_centers(centers: np.ndarray, resolution: float) -> np.ndarray:
    """World centers -> octomap 16-bit keys per axis (offset 32768)."""
    return (np.floor(centers / resolution).astype(np.int64) + 32768).astype(np.uint16)


def _centers_from_keys(keys: np.ndarray, resolution: float) -> np.ndarray:
    return (keys.astype(np.int64) - 32768 + 0.5) * resolution


class _Node:
    __slots__ = ("children", "value", "color")

    def __init__(self):
        self.children = [None] * 8
        self.value = 0.0
        self.color = (255, 255, 255)


def _build_tree(keys: np.ndarray, logodds: np.ndarray, colors: np.ndarray) -> _Node:
    root = _Node()
    for (kx, ky, kz), v, c in zip(keys, logodds, colors):
        node = root
        for depth in range(TREE_DEPTH):
            bit = TREE_DEPTH - 1 - depth
            i = (
                ((int(kx) >> bit) & 1)
                | (((int(ky) >> bit) & 1) << 1)
                | (((int(kz) >> bit) & 1) << 2)
            )
            if node.children[i] is None:
                node.children[i] = _Node()
            node = node.children[i]
        node.value = float(v)
        node.color = (int(c[0]), int(c[1]), int(c[2]))
    _propagate(root)
    return root


def _propagate(node: _Node) -> None:
    """Inner nodes take max child log-odds and average child color."""
    child_vals = []
    cols = []
    for ch in node.children:
        if ch is not None:
            _propagate(ch)
            child_vals.append(ch.value)
            cols.append(ch.color)
    if child_vals:
        node.value = max(child_vals)
        arr = np.asarray(cols, np.float64)
        node.color = tuple(int(x) for x in arr.mean(0))


def _write_node(out: bytearray, node: _Node) -> int:
    count = 1
    out += struct.pack("<f", node.value)
    out += bytes(node.color)
    mask = 0
    for i, ch in enumerate(node.children):
        if ch is not None:
            mask |= 1 << i
    out += struct.pack("<B", mask)
    for ch in node.children:
        if ch is not None:
            count += _write_node(out, ch)
    return count


def write_color_octree(path, centers, probs, colors, resolution) -> int:
    """Write occupied voxels as a ColorOcTree .ot file. Returns node count."""
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    probs = np.clip(np.asarray(probs, np.float64).reshape(-1), 1e-4, 1 - 1e-4)
    colors = np.asarray(colors).reshape(-1, 3)
    logodds = np.log(probs / (1 - probs)).astype(np.float32)
    keys = _keys_from_centers(centers, resolution)
    root = _build_tree(keys, logodds, colors)
    body = bytearray()
    n_nodes = _write_node(body, root) if len(centers) else 0
    header = (
        "# Octomap OcTree file\n"
        "# (feel free to add / change comments, but leave the first line as it is!)\n"
        "#\n"
        "id ColorOcTree\n"
        f"size {n_nodes}\n"
        f"res {resolution}\n"
        "data\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(bytes(body))
    return n_nodes


def read_color_octree(path):
    """Read a .ot written by write_color_octree.

    Returns (centers (M, 3), probs (M,), colors (M, 3) uint8, resolution) of
    the leaf voxels at max depth.
    """
    raw = Path(path).read_bytes()
    pos = 0
    res = None
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode(errors="replace").strip()
        pos = nl + 1
        if line.startswith("res "):
            res = float(line.split()[1])
        if line == "data":
            break
    leaves = []

    def parse(depth, kx, ky, kz):
        nonlocal pos
        value = struct.unpack_from("<f", raw, pos)[0]
        color = tuple(raw[pos + 4 : pos + 7])
        mask = raw[pos + 7]
        pos += 8
        has_children = False
        for i in range(8):
            if (mask >> i) & 1:
                has_children = True
                bit = TREE_DEPTH - 1 - depth
                parse(
                    depth + 1,
                    kx | ((i & 1) << bit),
                    ky | (((i >> 1) & 1) << bit),
                    kz | (((i >> 2) & 1) << bit),
                )
        if not has_children:
            leaves.append((kx, ky, kz, value, color))

    parse(0, 0, 0, 0)
    if not leaves:
        return np.zeros((0, 3)), np.zeros(0), np.zeros((0, 3), np.uint8), res
    arr = np.asarray([(kx, ky, kz) for kx, ky, kz, _, _ in leaves], np.uint16)
    vals = np.asarray([v for *_k, v, _c in leaves], np.float32)
    cols = np.asarray([c for *_k, _v, c in leaves], np.uint8)
    centers = _centers_from_keys(arr, res)
    probs = 1.0 / (1.0 + np.exp(-vals))
    return centers, probs, cols, res
