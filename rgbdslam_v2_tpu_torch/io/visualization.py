"""Debug and visualization exports: feature-flow images and graph geometry.

Port of ``rgbdslam_v2_tpu/io/visualization.py`` (``draw_feature_flow``,
``export_graph_ply``): numpy on the host, the same code.

* draw_feature_flow: keypoints and match-flow vectors between a frame and
  its best predecessor drawn on the frame (the reference's drawFeatureFlow,
  src/graph_mgr_io.cpp:1056-1160, the GUI's feature pane);
* export_graph_ply: graph nodes and edges as a PLY line set coloured by
  edge type (the reference's RViz marker topics, src/graph_mgr_io.cpp:687-932).
"""
from __future__ import annotations

import numpy as np


def draw_feature_flow(
    rgb: np.ndarray,
    uv_now: np.ndarray,
    uv_prev: np.ndarray,
    match_valid: np.ndarray,
    inliers: np.ndarray | None = None,
) -> np.ndarray:
    """Render keypoints + flow vectors onto a copy of the frame.

    Green = inlier match flow, red = outlier match, blue dot = keypoint.
    Pure numpy (host-side debug path; not perf-critical).
    """
    img = np.ascontiguousarray(rgb).copy()
    H, W = img.shape[:2]

    def dot(x, y, color, r=1):
        x0, x1 = max(0, x - r), min(W, x + r + 1)
        y0, y1 = max(0, y - r), min(H, y + r + 1)
        img[y0:y1, x0:x1] = color

    def line(x0, y0, x1, y1, color):
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
        xs = np.linspace(x0, x1, n + 1).round().astype(int)
        ys = np.linspace(y0, y1, n + 1).round().astype(int)
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        img[ys[ok], xs[ok]] = color

    green, red, blue = (0, 255, 0), (255, 60, 60), (80, 120, 255)
    marks = np.rint(np.asarray(uv_now)[np.asarray(match_valid, bool)]).astype(np.int64)
    if (inliers is None and np.array_equal(uv_now, uv_prev)
            and np.all((marks >= 0) & (marks <= [W, H]))):
        # a frame's own keypoints (the live view's pane): every flow is one
        # pixel under its own dot, so the image is the union of the dots,
        # in any order (the loop's result, without a Python step a mark)
        mask = np.zeros((H, W), bool)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                x, y = marks[:, 0] + dx, marks[:, 1] + dy
                ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
                mask[y[ok], x[ok]] = True
        img[mask] = blue
        return img
    for k in range(len(uv_now)):
        if not match_valid[k]:
            continue
        x1, y1 = int(round(uv_now[k, 0])), int(round(uv_now[k, 1]))
        x0, y0 = int(round(uv_prev[k, 0])), int(round(uv_prev[k, 1]))
        color = green if (inliers is None or inliers[k]) else red
        line(x0, y0, x1, y1, color)
        dot(x1, y1, blue)
    return img


def export_graph_ply(path, poses: np.ndarray, edge_pairs, edge_active,
                     edge_types=None) -> int:
    """Graph nodes + edges as a PLY line set (the RViz-marker equivalent).

    Nodes become vertices; each active edge becomes a line segment colored
    by type (sequential green, loop red, odometry blue, fallback gray).
    Returns the number of exported edges.
    """
    colors = {0: (0, 200, 0), 1: (230, 30, 30), 2: (60, 90, 230), 3: (150, 150, 150)}
    verts, vcols, lines = [], [], []
    for e, pair in enumerate(edge_pairs):
        if pair is None or not edge_active[e]:
            continue
        i, j = pair
        t = edge_types[e] if edge_types is not None else 0
        c = colors.get(t, (200, 200, 200))
        for nid in (i, j):
            verts.append(poses[nid][:3, 3])
            vcols.append(c)
        lines.append((len(verts) - 2, len(verts) - 1))
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element edge {len(lines)}",
        "property int vertex1", "property int vertex2",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec = np.empty(len(verts), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
        if verts:
            rec["xyz"] = np.asarray(verts, np.float32)
            rec["rgb"] = np.asarray(vcols, np.uint8)
        f.write(rec.tobytes())
        lrec = np.asarray(lines, np.int32)
        f.write(lrec.tobytes())
    return len(lines)
