"""Organized-cloud triangle meshing with a depth-jump test.

Port of ``rgbdslam_v2_tpu/io/meshing.py`` (``grid_mesh_faces``,
``compact_mesh``, ``merge_meshes``, ``write_ply_mesh``, ``read_ply_mesh``):
numpy on the host, the same code. The reference's GL viewer draws each
node's organized cloud as triangle strips and skips triangles that span a
depth discontinuity (src/glviewer.cpp:776-880, drawTriangleStrip /
pointCloud2GLTriangleStrip); here one vectorized pass over the (H, W) grid
emits an indexed triangle list: a grid quad gives its two triangles where
their three vertices are valid and no edge jumps more than ``jump_frac`` of
the triangle's largest depth.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def grid_mesh_faces(
    depth: np.ndarray, valid: np.ndarray, jump_frac: float = 0.05
) -> np.ndarray:
    """(H, W) depth + validity -> (F, 3) int32 triangle indices into the
    flattened grid.

    A triangle survives when its three vertices are valid and every pair
    of its depths differs by less than ``jump_frac * max(depth)`` of the
    triangle (the glviewer.cpp:776 depth-jump test, made scale-relative so
    near and far surfaces get comparable treatment).
    """
    H, W = depth.shape
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    # quad corners: a=(i,j) b=(i,j+1) c=(i+1,j) d=(i+1,j+1)
    a, b = idx[:-1, :-1], idx[:-1, 1:]
    c, d = idx[1:, :-1], idx[1:, 1:]
    za, zb = depth[:-1, :-1], depth[:-1, 1:]
    zc, zd = depth[1:, :-1], depth[1:, 1:]
    va, vb = valid[:-1, :-1], valid[:-1, 1:]
    vc, vd = valid[1:, :-1], valid[1:, 1:]

    def ok(z1, z2, z3, v1, v2, v3):
        zmax = np.maximum(np.maximum(z1, z2), z3)
        lim = jump_frac * zmax
        return (
            v1 & v2 & v3
            & (np.abs(z1 - z2) < lim)
            & (np.abs(z1 - z3) < lim)
            & (np.abs(z2 - z3) < lim)
        )

    # the two strip triangles per quad: (a, c, b) and (b, c, d) — wound so
    # normals face the camera (+z into the scene, y down)
    k1 = ok(za, zc, zb, va, vc, vb)
    k2 = ok(zb, zc, zd, vb, vc, vd)
    t1 = np.stack([a[k1], c[k1], b[k1]], axis=1)
    t2 = np.stack([b[k2], c[k2], d[k2]], axis=1)
    return np.concatenate([t1, t2], axis=0).astype(np.int32)


def compact_mesh(points: np.ndarray, colors: np.ndarray, faces: np.ndarray):
    """Drop vertices unused by ``faces`` and remap indices.

    points (N, 3) float32, colors (N, 3) uint8, faces (F, 3) int32 ->
    (verts, cols, faces') with faces' indexing the compacted arrays.
    """
    if len(faces) == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.uint8),
            np.zeros((0, 3), np.int32),
        )
    used, inv = np.unique(faces.reshape(-1), return_inverse=True)
    return (
        np.asarray(points, np.float32)[used],
        np.asarray(colors, np.uint8)[used],
        inv.reshape(-1, 3).astype(np.int32),
    )


def merge_meshes(parts):
    """[(verts, cols, faces), ...] -> one (verts, cols, faces)."""
    vs, cs, fs, off = [], [], [], 0
    for v, c, f in parts:
        if len(v) == 0:
            continue
        vs.append(v)
        cs.append(c)
        fs.append(f + off)
        off += len(v)
    if not vs:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.uint8),
            np.zeros((0, 3), np.int32),
        )
    return np.concatenate(vs), np.concatenate(cs), np.concatenate(fs)


def write_ply_mesh(path, verts: np.ndarray, colors: np.ndarray,
                   faces: np.ndarray) -> str:
    """Binary little-endian PLY with vertex colors + triangle faces (the
    format stock MeshLab/CloudCompare read)."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    vrec = np.zeros(
        len(verts),
        dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)],
    )
    vrec["xyz"] = verts
    vrec["rgb"] = colors
    frec = np.zeros(
        len(faces), dtype=[("n", np.uint8), ("idx", np.int32, 3)]
    )
    frec["n"] = 3
    frec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vrec.tobytes())
        f.write(frec.tobytes())
    return str(path)


def read_ply_mesh(path):
    """Read a mesh written by write_ply_mesh -> (verts, cols, faces)."""
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode()
    nv = nf = 0
    for line in header.splitlines():
        if line.startswith("element vertex"):
            nv = int(line.split()[-1])
        elif line.startswith("element face"):
            nf = int(line.split()[-1])
    vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
    vrec = np.frombuffer(raw, vdt, count=nv, offset=end)
    frec = np.frombuffer(raw, fdt, count=nf, offset=end + nv * vdt.itemsize)
    return (
        vrec["xyz"].copy(),
        vrec["rgb"].copy(),
        frec["idx"].astype(np.int32),
    )
