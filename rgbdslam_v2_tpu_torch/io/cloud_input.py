"""Point-cloud input: RGB-D frames from point clouds.

Port of ``rgbdslam_v2_tpu/io/cloud_input.py`` (``read_ply``, ``load_cloud``,
``cloud_to_rgbd``, ``CloudDataset``), numpy as there. Capability parity with
the reference's cloud-based Node construction (second Node ctor,
node.cpp:252-369), the live cloud topic (pcdCallback,
openni_listener.cpp:536; param ``topic_points``) and PCD-file loading
(loadPCDFiles(Async), openni_listener.cpp:1063-1100).

Clouds are converted at the input boundary into the organized (rgb u8
HxWx3, depth f32 HxW meters) grid every other input produces, so the one
per-frame device step serves all inputs unchanged. Organized clouds map
1:1 (their z channel is the depth image); unorganized clouds are z-buffer
splatted through the pinhole intrinsics.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.camera import Intrinsics
from .pointcloud import read_pcd


def read_ply(path):
    """Read a PLY file (binary little-endian or ascii; float x/y/z with
    optional uchar red/green/blue) -> (points (N,3) f32, colors u8|None).

    Counterpart of pointcloud.write_ply; accepts the property orderings
    PCL and this repo emit."""
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii", errors="replace").splitlines()
    fmt = None
    n = 0
    props = []  # (name, dtype) in file order, vertex element only
    in_vertex = False
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                n = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            props.append((tok[2], tok[1]))
    typemap = {"float": "<f4", "float32": "<f4", "double": "<f8",
               "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
               "ushort": "<u2", "short": "<i2", "char": "i1"}
    if fmt == "ascii":
        rows = np.loadtxt(
            [ln for ln in raw[end:].decode().splitlines() if ln.strip()],
            ndmin=2)
        cols_by_name = {name: rows[:n, i] for i, (name, _t) in
                        enumerate(props)}
    else:
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt!r}")
        dt = np.dtype([(name, typemap[t]) for name, t in props])
        rec = np.frombuffer(raw[end:], dt, count=n)
        cols_by_name = {name: rec[name] for name, _t in props}
    pts = np.stack([cols_by_name["x"], cols_by_name["y"],
                    cols_by_name["z"]], -1).astype(np.float32)
    colors = None
    if "red" in cols_by_name:
        colors = np.stack([cols_by_name["red"], cols_by_name["green"],
                           cols_by_name["blue"]], -1).astype(np.uint8)
    return pts, colors


def load_cloud(path):
    """Load a .pcd/.ply cloud -> (points, colors, organized_hw|None)."""
    path = Path(path)
    if path.suffix.lower() == ".pcd":
        pts, cols, (h, w) = read_pcd(path, return_shape=True)
        return pts, cols, ((h, w) if h > 1 else None)
    if path.suffix.lower() == ".ply":
        pts, cols = read_ply(path)
        return pts, cols, None
    raise ValueError(f"unsupported cloud file {path.name!r}")


def cloud_to_rgbd(points, colors, cam: Intrinsics, organized_hw=None):
    """Convert a camera-frame cloud to (rgb u8 HxWx3, depth f32 HxW m).

    Organized clouds (``organized_hw=(H,W)`` or a (H,W,3) ``points``
    array) keep their grid: depth = z channel, NaN/z<=0 -> 0 (invalid),
    integer-upsampled if the cloud was subsampled on write (the
    reference's cloud_creation_skip_step). Unorganized clouds are
    nearest-wins z-buffer splatted through the intrinsics — a superset of
    the reference, which requires organized input for its cloud ctor."""
    pts = np.asarray(points, np.float32)
    if pts.ndim == 3:
        organized_hw = pts.shape[:2]
        pts = pts.reshape(-1, 3)
    if colors is not None:
        colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    H, W = cam.height, cam.width
    if organized_hw is not None:
        oh, ow = organized_hw
        if H % oh == 0 and W % ow == 0:
            grid = pts.reshape(oh, ow, 3)
            z = grid[..., 2]
            depth = np.where(np.isfinite(z) & (z > 0), z, 0.0)
            if colors is not None:
                rgb = colors.reshape(oh, ow, 3)
            else:
                rgb = np.full((oh, ow, 3), 128, np.uint8)
            sy, sx = H // oh, W // ow
            if sy > 1 or sx > 1:
                depth = depth.repeat(sy, 0).repeat(sx, 1)
                rgb = rgb.repeat(sy, 0).repeat(sx, 1)
            return rgb, depth.astype(np.float32)
        # organized but incommensurate with the camera -> fall through
    depth = np.zeros((H, W), np.float32)
    rgb = np.full((H, W, 3), 128, np.uint8)
    z = pts[:, 2]
    ok = np.isfinite(z) & (z > 1e-6) & np.isfinite(pts[:, 0]) & np.isfinite(
        pts[:, 1])
    pts = pts[ok]
    cols = colors[ok] if colors is not None else None
    z = pts[:, 2]
    u = np.round(cam.fx * pts[:, 0] / z + cam.cx).astype(np.int64)
    v = np.round(cam.fy * pts[:, 1] / z + cam.cy).astype(np.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, z = u[inb], v[inb], z[inb]
    if cols is not None:
        cols = cols[inb]
    # nearest-wins: write far-to-near so the closest point lands last
    order = np.argsort(-z, kind="stable")
    u, v, z = u[order], v[order], z[order]
    depth[v, u] = z
    if cols is not None:
        rgb[v, u] = cols[order]
    return rgb, depth


class CloudDataset:
    """A directory of .pcd/.ply files as a frame source (the reference's
    loadPCDFiles input, openni_listener.cpp:1063).  Files are ordered by
    name; a float filename stem is its timestamp (TUM convention),
    otherwise stamps run at 30 Hz."""

    def __init__(self, files, cam: Intrinsics):
        self.files = list(files)
        self.cam = cam
        self.stamps = []
        for i, f in enumerate(self.files):
            try:
                self.stamps.append(float(Path(f).stem))
            except ValueError:
                self.stamps.append(i / 30.0)

    @classmethod
    def open(cls, directory, cam: Intrinsics) -> "CloudDataset":
        d = Path(directory)
        files = sorted(
            p for p in d.iterdir() if p.suffix.lower() in (".pcd", ".ply"))
        if not files:
            raise FileNotFoundError(f"no .pcd/.ply files in {directory}")
        return cls(files, cam)

    def __len__(self):
        return len(self.files)

    def load(self, i: int):
        """-> (stamp, rgb u8 HxWx3, depth f32 HxW meters)."""
        pts, cols, hw = load_cloud(self.files[i])
        rgb, depth = cloud_to_rgbd(pts, cols, self.cam, organized_hw=hw)
        return self.stamps[i], rgb, depth
