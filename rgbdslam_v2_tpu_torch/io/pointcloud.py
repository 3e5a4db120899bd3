"""Point cloud export: PCD and PLY writers (+ voxel-grid downsampling).

Port of ``rgbdslam_v2_tpu/io/pointcloud.py`` (``voxel_downsample``,
``write_pcd``, ``read_pcd``, ``write_ply``), numpy as there. The reference saves aggregate and per-node clouds as
.pcd/.ply via PCL (reference: graph_mgr_io.cpp:502-582 saveAllCloudsToFile,
:330 saveIndividualCloudsToFile) with optional voxel-grid filtering
(pcl VoxelGrid; param voxelfilter_size).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def voxel_downsample(points: np.ndarray, colors: np.ndarray, voxel: float):
    """Average points/colors per voxel (PCL VoxelGrid semantics)."""
    if voxel <= 0 or len(points) == 0:
        return points, colors
    keys = np.floor(points / voxel).astype(np.int64)
    # pack 3x int21 into one int64 key
    packed = (
        (keys[:, 0] + (1 << 20)) * (1 << 42)
        + (keys[:, 1] + (1 << 20)) * (1 << 21)
        + (keys[:, 2] + (1 << 20))
    )
    order = np.argsort(packed)
    packed = packed[order]
    pts = points[order]
    cols = colors[order].astype(np.float64)
    uniq, start = np.unique(packed, return_index=True)
    sums_p = np.add.reduceat(pts, start, axis=0)
    sums_c = np.add.reduceat(cols, start, axis=0)
    counts = np.diff(np.append(start, len(packed)))[:, None]
    return sums_p / counts, (sums_c / counts).clip(0, 255).astype(np.uint8)


def write_pcd(path, points: np.ndarray, colors: np.ndarray | None = None,
              binary: bool = True, organized_hw: "tuple | None" = None):
    """Write a PCD v0.7 file (xyz or xyzrgb).

    ``organized_hw=(H, W)`` writes an organized cloud (PCL convention:
    HEIGHT>1, invalid points carried as NaN rows), the format the
    reference's cloud-input path consumes (node.cpp:252-369)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    if organized_hw is not None:
        oh, ow = organized_hw
        if oh * ow != n:
            raise ValueError(f"organized_hw {organized_hw} != {n} points")
    else:
        oh, ow = 1, n
    has_rgb = colors is not None
    fields = "x y z rgb" if has_rgb else "x y z"
    sizes = "4 4 4 4" if has_rgb else "4 4 4"
    types = "F F F F" if has_rgb else "F F F"
    counts = "1 1 1 1" if has_rgb else "1 1 1"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {ow}\nHEIGHT {oh}\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if has_rgb:
            c = np.asarray(colors, np.uint32).reshape(-1, 3)
            rgb = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
            rgb_f = rgb.astype(np.uint32).view(np.float32)
            data = np.column_stack([points, rgb_f]).astype(np.float32)
        else:
            data = points
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path, return_shape: bool = False):
    """Minimal PCD reader (binary xyz[rgb]); ``return_shape`` adds the
    (HEIGHT, WIDTH) organization of the cloud to the return tuple."""
    raw = Path(path).read_bytes()
    end = raw.index(b"DATA")
    header = raw[:end].decode()
    meta = dict(
        line.split(maxsplit=1) for line in header.strip().splitlines()
        if not line.startswith("#")
    )
    n = int(meta["POINTS"])
    fields = meta["FIELDS"].split()
    data_line_end = raw.index(b"\n", end)
    body = raw[data_line_end + 1 :]
    arr = np.frombuffer(body, np.float32, count=n * len(fields)).reshape(n, len(fields))
    pts = arr[:, :3]
    cols = None
    if "rgb" in fields:
        rgb = arr[:, 3].view(np.uint32)
        cols = np.stack([(rgb >> 16) & 255, (rgb >> 8) & 255, rgb & 255], -1).astype(np.uint8)
    if return_shape:
        return pts, cols, (int(meta["HEIGHT"]), int(meta["WIDTH"]))
    return pts, cols


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None):
    """Write a binary-little-endian PLY file."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    has_rgb = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_rgb:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_rgb:
            cols = np.asarray(colors, np.uint8).reshape(-1, 3)
            rec = np.empty(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(points.tobytes())
