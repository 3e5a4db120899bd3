"""Headless 3D rendering of SLAM results: the GL viewer capability, offline.

Port of ``rgbdslam_v2_tpu/io/render3d.py`` (``look_at``,
``render_points``, ``_project``, ``_draw_line``, ``overlay_trajectory``,
``render_orbit_views``): numpy on the host, the same code, so that
``view`` never touches the card. The reference's OpenGL viewer draws the
registered point clouds, the camera trajectory with pose axes and the
graph edges in a window (src/glviewer.cpp:693-736 addPointCloud, pose
axes and edges :400-600, drawToPS :1169); here a z-buffered point
splatter renders the map, trajectory and edges from any viewpoint, and
``render_orbit_views`` writes N views around the map for the
``rgbdslam-torch view`` command. ``write_png`` writes through the port's
own PNG codec (``io/png.py``; the JAX version tries cv2, which the card's
machine does not have): the same pixels.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """world_T_cam for a camera at `eye` looking at `target` (OpenCV axes:
    +z forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, np.asarray(up, np.float64))
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T


def render_points(
    points: np.ndarray,  # (N, 3) world
    colors: Optional[np.ndarray],  # (N, 3) uint8 or None
    world_T_cam: np.ndarray,  # (4, 4)
    size: Tuple[int, int] = (960, 720),
    fov_deg: float = 60.0,
    splat: int = 2,
    background: int = 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """Z-buffered point splatting -> (rgb (H, W, 3) uint8, depth (H, W)).

    Points are projected with a pinhole camera; each point covers a
    splat x splat pixel block; nearest point wins per pixel (the painter
    problem the GL depth test solves, done with np.minimum.at here)."""
    W, H = size
    f = 0.5 * W / np.tan(np.radians(fov_deg) / 2)
    cam_T_world = np.linalg.inv(world_T_cam)
    pc = points @ cam_T_world[:3, :3].T + cam_T_world[:3, 3]
    z = pc[:, 2]
    front = z > 1e-3
    pc, z = pc[front], z[front]
    cols = (colors[front] if colors is not None
            else np.full((len(pc), 3), 200, np.uint8))
    u = (pc[:, 0] / z * f + W / 2).astype(np.int32)
    v = (pc[:, 1] / z * f + H / 2).astype(np.int32)
    rgb = np.full((H, W, 3), background, np.uint8)
    zbuf = np.full(H * W, np.inf, np.float32)
    for dv in range(splat):
        for du in range(splat):
            uu, vv = u + du, v + dv
            ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            idx = vv[ok] * W + uu[ok]
            np.minimum.at(zbuf, idx, z[ok].astype(np.float32))
    # second pass: write color where this point owns the z-buffer
    flat = rgb.reshape(-1, 3)
    for dv in range(splat):
        for du in range(splat):
            uu, vv = u + du, v + dv
            ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
            idx = vv[ok] * W + uu[ok]
            own = z[ok].astype(np.float32) <= zbuf[idx] * (1 + 1e-4)
            flat[idx[own]] = cols[ok][own]
    return rgb, zbuf.reshape(H, W)


def _project(pts_w: np.ndarray, world_T_cam, f, W, H):
    cam_T_world = np.linalg.inv(world_T_cam)
    pc = pts_w @ cam_T_world[:3, :3].T + cam_T_world[:3, 3]
    z = np.maximum(pc[:, 2], 1e-3)
    u = pc[:, 0] / z * f + W / 2
    v = pc[:, 1] / z * f + H / 2
    return u, v, pc[:, 2]


def _draw_line(img, p0, p1, color):
    """Integer DDA line (no cv2 dependency in the hot import path)."""
    x0, y0 = p0
    x1, y1 = p1
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    if n > 10000:  # off-screen blowup guard
        return
    xs = np.linspace(x0, x1, n).astype(np.int32)
    ys = np.linspace(y0, y1, n).astype(np.int32)
    H, W = img.shape[:2]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def overlay_trajectory(
    img: np.ndarray,
    world_T_cam: np.ndarray,
    traj: np.ndarray,  # (T, 4, 4) camera poses to draw
    edges: Optional[Sequence[Tuple[int, int]]] = None,
    fov_deg: float = 60.0,
    axis_len: float = 0.05,
    axis_every: int = 10,
):
    """Draw the trajectory polyline, loop/graph edges, and pose axes into a
    rendered view (the glviewer edge/axes overlay)."""
    H, W = img.shape[:2]
    f = 0.5 * W / np.tan(np.radians(fov_deg) / 2)
    centers = traj[:, :3, 3]
    u, v, z = _project(centers, world_T_cam, f, W, H)
    vis = z > 1e-2
    for i in range(len(traj) - 1):
        if vis[i] and vis[i + 1]:
            _draw_line(img, (u[i], v[i]), (u[i + 1], v[i + 1]),
                       np.array([255, 255, 0], np.uint8))
    if edges:
        for (a, b) in edges:
            if a < len(traj) and b < len(traj) and vis[a] and vis[b] \
                    and abs(a - b) > 1:
                _draw_line(img, (u[a], v[a]), (u[b], v[b]),
                           np.array([255, 64, 64], np.uint8))
    axis_cols = (np.array([255, 0, 0], np.uint8),
                 np.array([0, 255, 0], np.uint8),
                 np.array([64, 128, 255], np.uint8))
    for i in range(0, len(traj), max(1, axis_every)):
        if not vis[i]:
            continue
        for ax in range(3):
            tip = centers[i] + traj[i, :3, ax] * axis_len
            tu, tv, tz = _project(tip[None], world_T_cam, f, W, H)
            if tz[0] > 1e-2:
                _draw_line(img, (u[i], v[i]), (tu[0], tv[0]), axis_cols[ax])
    return img


def write_png(path, rgb: np.ndarray) -> None:
    """An (H, W, 3) u8 image as an RGB PNG (io/png.write_png)."""
    from .png import write_png as _write

    _write(path, np.asarray(rgb, np.uint8))


def render_orbit_views(
    points: np.ndarray,
    colors: Optional[np.ndarray],
    out_dir,
    traj: Optional[np.ndarray] = None,
    edges: Optional[Sequence[Tuple[int, int]]] = None,
    n_views: int = 6,
    size: Tuple[int, int] = (960, 720),
    max_points: int = 400_000,
) -> list:
    """Render n views orbiting the map's centroid; returns written paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(
            len(points), max_points, replace=False)
        points = points[sel]
        colors = colors[sel] if colors is not None else None
    center = points.mean(0)
    radius = 2.5 * np.percentile(np.linalg.norm(points - center, axis=1), 90)
    paths = []
    for k in range(n_views):
        ang = 2 * np.pi * k / n_views
        eye = center + radius * np.array(
            [np.cos(ang), -0.35, np.sin(ang)])
        T = look_at(eye, center)
        img, _ = render_points(points, colors, T, size=size)
        if traj is not None:
            overlay_trajectory(img, T, traj, edges)
        p = out / f"view_{k:02d}.png"
        write_png(p, img)
        paths.append(str(p))
    return paths
