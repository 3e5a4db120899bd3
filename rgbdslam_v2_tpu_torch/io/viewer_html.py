"""Interactive 3D viewer: the GL-viewer capability, in the browser.

Port of ``rgbdslam_v2_tpu/io/viewer_html.py`` (``_b64``, ``_line_verts``,
``build_viewer_html``, ``write_viewer_html`` and the HTML/JS template): the
same code and template, so that the same inputs give the same page, byte
for byte. The reference's interactive OpenGL widget rotates, pans and
zooms the registered cloud, trajectory polyline, graph edges and pose
axes, with a point-size control and a background toggle
(src/glviewer.cpp:121-200 input handling, :400-736 draw paths). Here it
is ONE self-contained HTML file: positions and colours embedded as base64
typed arrays and drawn with hand-written WebGL (no external JS, works
from file:// offline). ``rgbdslam-torch view --html`` writes it beside
the PNG orbit renders; ``rgbdslam-torch serve`` and ``run --serve`` serve
it with live reload (and, for ``run --serve``, the run controls).

Interactions (mirroring glviewer's mouse handling):
  drag          orbit the map centroid
  right-drag /  pan the orbit target
  shift-drag
  wheel         dolly in/out
  keys 1/2/3    point size, t/e/a toggles for trajectory/edges/axes
  dblclick      reset view (glviewer.cpp:186 double-click home)
"""
from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 html,body{{margin:0;height:100%;overflow:hidden;background:#101014;
  font:12px system-ui,sans-serif;color:#cfcfd6}}
 #c{{width:100%;height:100%;display:block;cursor:grab}}
 #hud{{position:fixed;top:8px;left:8px;background:rgba(16,16,20,.82);
  padding:8px 10px;border-radius:6px;line-height:1.7;user-select:none}}
 #hud label{{display:block;cursor:pointer}}
 #stats{{position:fixed;bottom:8px;left:8px;opacity:.7}}
 input[type=range]{{vertical-align:middle;width:90px}}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <b>{title}</b><br>
 <label>point size <input id="psize" type="range" min="1" max="8"
  step="0.5" value="2"></label>
 <label><input id="tTraj" type="checkbox" checked> trajectory (t)</label>
 <label><input id="tEdges" type="checkbox" checked> graph edges (e)</label>
 <label><input id="tAxes" type="checkbox" checked> pose axes (a)</label>
 <label id="voxRow" style="display:none"><input id="tVox" type="checkbox">
  octomap voxels (v)</label>
 <label id="meshRow" style="display:none"><input id="tMesh" type="checkbox">
  triangle mesh (m)</label>
 <label id="sigRow" style="display:none"><input id="tSig" type="checkbox">
  &sigma; ellipsoid splats (u)</label>
 <span style="opacity:.6">drag orbit · right-drag pan · wheel zoom ·
 dblclick reset</span>{ctl_html}
</div>
<div id="stats"></div>
<script>
"use strict";
const B64 = s => {{
  const bin = atob(s); const u = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) u[i] = bin.charCodeAt(i);
  return u;
}};
const DATA = {data_json};
const pos = new Float32Array(B64(DATA.pos).buffer);
const col = B64(DATA.col);
const NPTS = pos.length / 3;
const lines = new Float32Array(B64(DATA.lines).buffer);   // xyzrgb per vert
const NLINE = lines.length / 6;

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {{antialias: true}});
const VS = `attribute vec3 p; attribute vec3 c; attribute float s;
 uniform mat4 mvp; uniform float ps; uniform float persp; varying vec3 vc;
 void main(){{
   gl_Position = mvp * vec4(p,1.0);
   // persp > 0: world-sized point (octomap voxel splat or sigma-scaled
   // uncertainty splat, glviewer.cpp:922 ellipsoid mode) — pixel size is
   // the projected world size s*persp; else a fixed screen-size point
   gl_PointSize = persp > 0.0
     ? clamp(s * persp / max(gl_Position.w, 1e-3), 1.0, 64.0) : ps;
   vc = c;
 }}`;
const FS = `precision mediump float; varying vec3 vc;
 void main(){{ gl_FragColor = vec4(vc, 1.0); }}`;
function shader(type, src) {{
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const aP = gl.getAttribLocation(prog, "p");
const aC = gl.getAttribLocation(prog, "c");
const aS = gl.getAttribLocation(prog, "s");
const uMVP = gl.getUniformLocation(prog, "mvp");
const uPS = gl.getUniformLocation(prog, "ps");
const uPersp = gl.getUniformLocation(prog, "persp");
gl.vertexAttrib1f(aS, 1.0);  // default: unit world-size scale

function buf(data) {{
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); return b;
}}
const bPos = buf(pos);
const colF = new Float32Array(NPTS * 3);
for (let i = 0; i < NPTS * 3; i++) colF[i] = col[i] / 255;
const bCol = buf(colF);
const bLines = buf(lines);
// octomap voxel layer (occupied-leaf centers, world-sized splats)
const vpos = new Float32Array(B64(DATA.vpos).buffer);
const NVOX = vpos.length / 3;
let bVPos = null, bVCol = null;
if (NVOX > 0) {{
  bVPos = buf(vpos);
  const vcol8 = B64(DATA.vcol);
  const vcolF = new Float32Array(NVOX * 3);
  for (let i = 0; i < NVOX * 3; i++) vcolF[i] = vcol8[i] / 255;
  bVCol = buf(vcolF);
  voxRow.style.display = "block";
}}
// triangle mesh layer (depth-jump-tested node grids, glviewer.cpp:776)
const mpos = new Float32Array(B64(DATA.mpos).buffer);
const midx = new Uint32Array(B64(DATA.midx).buffer);
const NTRI = midx.length / 3;
let bMPos = null, bMCol = null, bMIdx = null;
if (NTRI > 0) {{
  gl.getExtension("OES_element_index_uint");
  bMPos = buf(mpos);
  const mcol8 = B64(DATA.mcol);
  const mcolF = new Float32Array(mcol8.length);
  for (let i = 0; i < mcol8.length; i++) mcolF[i] = mcol8[i] / 255;
  bMCol = buf(mcolF);
  bMIdx = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, bMIdx);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, midx, gl.STATIC_DRAW);
  meshRow.style.display = "block";
}}
// per-point measurement-sigma splat scales (ellipsoid mode, glviewer.cpp:922)
const sigma = new Float32Array(B64(DATA.sigma).buffer);
let bSig = null;
if (sigma.length === NPTS && NPTS > 0) {{
  bSig = buf(sigma);
  sigRow.style.display = "block";
}}

// line index ranges [start, count] per group: 0 traj, 1 edges, 2 axes
const GROUPS = DATA.groups;

// ---- camera ---------------------------------------------------------------
const center0 = DATA.center, radius0 = DATA.radius;
let yaw, pitch, dist, target;
function home() {{
  yaw = 0.6; pitch = -0.35; dist = radius0 * 2.2;
  target = center0.slice();
}}
home();
function mat() {{
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const eye = [target[0] + dist * cp * sy,
               target[1] + dist * sp,
               target[2] + dist * cp * cy];
  // look-at view matrix
  let f = [target[0]-eye[0], target[1]-eye[1], target[2]-eye[2]];
  const fl = Math.hypot(...f); f = f.map(v => v / fl);
  const upw = [0, -1, 0];  // OpenCV-style y-down world
  let r = [f[1]*upw[2]-f[2]*upw[1], f[2]*upw[0]-f[0]*upw[2],
           f[0]*upw[1]-f[1]*upw[0]];
  const rl = Math.hypot(...r) || 1; r = r.map(v => v / rl);
  const d = [r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0]];
  const tx = -(r[0]*eye[0]+r[1]*eye[1]+r[2]*eye[2]);
  const ty = -(d[0]*eye[0]+d[1]*eye[1]+d[2]*eye[2]);
  const tz = f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2];
  const V = [r[0],d[0],-f[0],0, r[1],d[1],-f[1],0, r[2],d[2],-f[2],0,
             tx,ty,tz,1];
  const asp = canvas.width / canvas.height;
  const near = Math.max(radius0 * 1e-3, dist * 1e-3), far = dist + radius0 * 20;
  const t = near * Math.tan(30 * Math.PI / 180);
  const P = [near/(t*asp),0,0,0, 0,near/t,0,0,
             0,0,-(far+near)/(far-near),-1, 0,0,-2*far*near/(far-near),0];
  // P * V
  const M = new Float32Array(16);
  for (let i2 = 0; i2 < 4; i2++) for (let j = 0; j < 4; j++) {{
    let s = 0;
    for (let k = 0; k < 4; k++) s += P[k*4+j] * V[i2*4+k];
    M[i2*4+j] = s;
  }}
  return M;
}}

function draw() {{
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth * dpr, h = canvas.clientHeight * dpr;
  if (canvas.width !== w || canvas.height !== h) {{
    canvas.width = w; canvas.height = h;
  }}
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.063, 0.063, 0.078, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const M = mat();
  gl.uniformMatrix4fv(uMVP, false, M);
  gl.uniform1f(uPS, parseFloat(psize.value) * (window.devicePixelRatio||1));
  gl.uniform1f(uPersp, 0.0);
  gl.enableVertexAttribArray(aP); gl.enableVertexAttribArray(aC);
  const t30 = Math.tan(30 * Math.PI / 180);
  gl.bindBuffer(gl.ARRAY_BUFFER, bPos);
  gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, bCol);
  gl.vertexAttribPointer(aC, 3, gl.FLOAT, false, 0, 0);
  if (bSig && tSig.checked) {{
    // sigma ellipsoid mode (glviewer.cpp:922): world-sized splats, each
    // scaled by its measurement sigma (2sigma diameter)
    gl.enableVertexAttribArray(aS);
    gl.bindBuffer(gl.ARRAY_BUFFER, bSig);
    gl.vertexAttribPointer(aS, 1, gl.FLOAT, false, 0, 0);
    gl.uniform1f(uPersp, 2.0 * h / (2 * t30));
    gl.drawArrays(gl.POINTS, 0, NPTS);
    gl.disableVertexAttribArray(aS);
    gl.vertexAttrib1f(aS, 1.0);
    gl.uniform1f(uPersp, 0.0);
  }} else {{
    gl.drawArrays(gl.POINTS, 0, NPTS);
  }}
  if (NTRI > 0 && tMesh.checked) {{
    gl.bindBuffer(gl.ARRAY_BUFFER, bMPos);
    gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, bMCol);
    gl.vertexAttribPointer(aC, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, bMIdx);
    gl.drawElements(gl.TRIANGLES, NTRI * 3, gl.UNSIGNED_INT, 0);
  }}
  if (NVOX > 0 && tVox.checked) {{
    // projected voxel edge in pixels: edge * (H/2) / (tan(fov/2) * w)
    const t30 = Math.tan(30 * Math.PI / 180);
    gl.uniform1f(uPersp, DATA.voxel_size * h / (2 * t30));
    gl.bindBuffer(gl.ARRAY_BUFFER, bVPos);
    gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, bVCol);
    gl.vertexAttribPointer(aC, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.POINTS, 0, NVOX);
    gl.uniform1f(uPersp, 0.0);
  }}
  // lines: interleaved xyz rgb
  gl.bindBuffer(gl.ARRAY_BUFFER, bLines);
  gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 24, 0);
  gl.vertexAttribPointer(aC, 3, gl.FLOAT, false, 24, 12);
  const show = [tTraj.checked, tEdges.checked, tAxes.checked];
  for (let g = 0; g < GROUPS.length; g++)
    if (show[g] && GROUPS[g][1] > 0)
      gl.drawArrays(gl.LINES, GROUPS[g][0], GROUPS[g][1]);
  stats.textContent = NPTS.toLocaleString() + " points · " +
    (GROUPS[0][1]/2) + " traj segs · " + (GROUPS[1][1]/2) + " edges";
}}
function frame() {{ draw(); requestAnimationFrame(frame); }}

// ---- input (glviewer.cpp:121-200 equivalents) -----------------------------
let drag = null;
canvas.addEventListener("mousedown", e => {{
  drag = {{x: e.clientX, y: e.clientY, pan: e.button === 2 || e.shiftKey}};
  canvas.style.cursor = "grabbing";
}});
window.addEventListener("mouseup", () => {{
  drag = null; canvas.style.cursor = "grab";
}});
window.addEventListener("mousemove", e => {{
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {{
    const s = dist * 0.0015;
    const cy = Math.cos(yaw), sy = Math.sin(yaw);
    target[0] -= dx * s * cy; target[2] += dx * s * sy;
    target[1] -= dy * s;
  }} else {{
    yaw -= dx * 0.006;
    pitch = Math.max(-1.55, Math.min(1.55, pitch - dy * 0.006));
  }}
}});
canvas.addEventListener("wheel", e => {{
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.0012);
  dist = Math.max(radius0 * 0.05, Math.min(radius0 * 40, dist));
}}, {{passive: false}});
canvas.addEventListener("contextmenu", e => e.preventDefault());
canvas.addEventListener("dblclick", home);
window.addEventListener("keydown", e => {{
  if (e.key === "t") tTraj.checked = !tTraj.checked;
  if (e.key === "e") tEdges.checked = !tEdges.checked;
  if (e.key === "a") tAxes.checked = !tAxes.checked;
  if (e.key === "v" && NVOX > 0) tVox.checked = !tVox.checked;
  if (e.key === "m" && NTRI > 0) tMesh.checked = !tMesh.checked;
  if (e.key === "u" && bSig) tSig.checked = !tSig.checked;
  if (e.key >= "1" && e.key <= "8") psize.value = e.key;
}});
{live_js}
frame();
</script></body></html>
"""

_LIVE_JS = """
// live mode: poll the serving process for a newer state generation and
// reload when the SLAM run has produced more of the map
async function poll() {
  try {
    const r = await fetch("gen", {cache: "no-store"});
    const gen = parseInt(await r.text(), 10);
    if (Number.isFinite(gen) && gen > DATA.gen) location.reload();
  } catch (e) { /* server gone: keep the last view */ }
  setTimeout(poll, 2000);
}
setTimeout(poll, 2000);
// 2D panes: the run's current frame + its keypoints, and the depth image
// (the GUI's visual/depth image panes); each hidden until its png exists
const pane = document.createElement("img");
pane.style.cssText = "position:fixed;right:8px;bottom:8px;max-width:32%;" +
  "border:1px solid #333;border-radius:4px;display:none";
pane.onload = () => { pane.style.display = "block"; };
pane.src = "frame.png?g=" + DATA.gen;
document.body.appendChild(pane);
const dpane = document.createElement("img");
dpane.style.cssText = "position:fixed;left:8px;bottom:8px;max-width:24%;" +
  "border:1px solid #333;border-radius:4px;display:none";
dpane.onload = () => { dpane.style.display = "block"; };
dpane.src = "depth.png?g=" + DATA.gen;
document.body.appendChild(dpane);
"""

# run controls (only when the server has a live pipeline attached): the
# reference GUI's pause / step-one-frame / save actions as /ctl endpoints
_CTL_HTML = """
 <div style="margin-top:6px;border-top:1px solid #333;padding-top:6px">
  <button id="bPause">pause</button>
  <button id="bStep">step</button>
  <button id="bSave">save cloud</button>
  <span id="ctlMsg" style="opacity:.7"></span>
 </div>
 <div style="margin-top:4px">
  <input id="pName" placeholder="param" size="20" style="font-size:11px">
  <input id="pValue" placeholder="value" size="8" style="font-size:11px">
  <button id="bParam">set</button>
 </div>
"""

_CTL_JS = """
async function ctl(action, btn) {
  try {
    const r = await fetch("ctl/" + action, {method: "POST"});
    const j = await r.json();
    ctlMsg.textContent = j.status;
    if (action === "pause")
      btn.textContent = j.status === "paused" ? "resume" : "pause";
  } catch (e) { ctlMsg.textContent = "control failed"; }
}
bPause.onclick = () => ctl("pause", bPause);
bStep.onclick = () => ctl("step", bStep);
bSave.onclick = () => ctl("save", bSave);
bParam.onclick = () => ctl("param?name=" + encodeURIComponent(pName.value) +
                           "&value=" + encodeURIComponent(pValue.value),
                           bParam);
"""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _line_verts(p0s, p1s, color) -> np.ndarray:
    """(M,3),(M,3),rgb -> (2M, 6) interleaved xyzrgb line vertex rows."""
    m = len(p0s)
    out = np.empty((2 * m, 6), np.float32)
    out[0::2, :3] = p0s
    out[1::2, :3] = p1s
    out[:, 3:] = np.asarray(color, np.float32)
    return out


def build_viewer_html(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    traj: Optional[np.ndarray] = None,  # (T, 4, 4) world_T_cam
    edges: Optional[Sequence[Tuple[int, int]]] = None,
    title: str = "rgbdslam_v2_tpu map",
    max_points: int = 600_000,
    axis_len: float = 0.05,
    axis_every: int = 10,
    live: bool = False,
    controls: bool = False,
    generation: int = 0,
    voxels: Optional[np.ndarray] = None,  # (V, 3) occupied-leaf centers
    voxel_colors: Optional[np.ndarray] = None,  # (V, 3) uint8
    voxel_size: float = 0.05,
    max_voxels: int = 400_000,
    mesh: Optional[tuple] = None,  # (verts (M,3), cols (M,3) u8, faces (F,3))
    sigmas: Optional[np.ndarray] = None,  # (N,) per-point splat size, meters
) -> str:
    """Build the self-contained interactive viewer HTML (returns the text).

    points (N, 3) float; colors (N, 3) uint8 (default light gray); traj
    draws a yellow polyline + rgb pose axes every `axis_every` poses; edges
    (index pairs into traj, |i-j|>1, the loop/graph edges) draw red, like
    the reference viewer's edge rendering (glviewer.cpp:400-600)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    if colors is None:
        colors = np.full((len(points), 3), 200, np.uint8)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    if sigmas is not None:
        sigmas = np.asarray(sigmas, np.float32).reshape(-1)
    if sigmas is not None and len(sigmas) != len(points):
        sigmas = None  # mismatched sigmas would pair wrong values with points
    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(
            len(points), max_points, replace=False)
        points, colors = points[sel], colors[sel]
        if sigmas is not None:
            sigmas = sigmas[sel]

    groups = []
    segs = []
    # group 0: trajectory polyline (yellow)
    start = 0
    if traj is not None and len(traj) >= 2:
        centers = np.asarray(traj)[:, :3, 3].astype(np.float32)
        segs.append(_line_verts(centers[:-1], centers[1:], (1.0, 1.0, 0.2)))
    groups.append([start, 0 if not segs else len(segs[-1])])
    start += groups[-1][1]
    # group 1: graph edges (red)
    n_edge = 0
    if traj is not None and edges:
        centers = np.asarray(traj)[:, :3, 3].astype(np.float32)
        pairs = [(a, b) for (a, b) in edges
                 if abs(a - b) > 1 and a < len(centers) and b < len(centers)]
        if pairs:
            a_idx = np.array([p[0] for p in pairs])
            b_idx = np.array([p[1] for p in pairs])
            v = _line_verts(centers[a_idx], centers[b_idx], (1.0, 0.3, 0.3))
            segs.append(v)
            n_edge = len(v)
    groups.append([start, n_edge])
    start += n_edge
    # group 2: pose axes triads (x red / y green / z blue)
    n_axis = 0
    if traj is not None and len(traj):
        T = np.asarray(traj, np.float32)
        sub = T[:: max(1, axis_every)]
        c = sub[:, :3, 3]
        for ax, col in ((0, (1, 0.25, 0.25)), (1, (0.25, 1, 0.25)),
                        (2, (0.35, 0.55, 1))):
            tips = c + sub[:, :3, ax] * axis_len
            v = _line_verts(c, tips, col)
            segs.append(v)
            n_axis += len(v)
    groups.append([start, n_axis])

    line_arr = (np.concatenate(segs, 0) if segs
                else np.zeros((0, 6), np.float32))
    # frame whatever geometry exists: cloud, else voxels, else trajectory
    if len(points):
        frame_pts = points
    elif voxels is not None and len(np.atleast_2d(voxels)):
        frame_pts = np.asarray(voxels, np.float32).reshape(-1, 3)
    elif traj is not None and len(traj):
        frame_pts = np.asarray(traj)[:, :3, 3].astype(np.float32)
    else:
        frame_pts = None
    if frame_pts is not None and len(frame_pts):
        center = frame_pts.mean(0)
        radius = float(np.percentile(
            np.linalg.norm(frame_pts - center, axis=1), 90))
    else:
        center = np.zeros(3)
        radius = 1.0
    if voxels is not None and len(voxels):
        # octomap layer: occupied-leaf centers drawn as world-sized splats
        # (the reference's renderableOctomap / ColorOctomapServer::render
        # voxel cubes, ColorOctomapServer.cpp:187-268)
        voxels = np.asarray(voxels, np.float32).reshape(-1, 3)
        if voxel_colors is None:
            voxel_colors = np.full((len(voxels), 3), 160, np.uint8)
        voxel_colors = np.asarray(voxel_colors, np.uint8).reshape(-1, 3)
        if len(voxels) > max_voxels:
            sel = np.random.default_rng(1).choice(
                len(voxels), max_voxels, replace=False)
            voxels, voxel_colors = voxels[sel], voxel_colors[sel]
    else:
        voxels = np.zeros((0, 3), np.float32)
        voxel_colors = np.zeros((0, 3), np.uint8)
    data = {
        "pos": _b64(points),
        "col": _b64(colors),
        "lines": _b64(line_arr),
        "groups": groups,
        "center": [float(x) for x in center],
        "radius": max(radius, 1e-3),
        "gen": generation,
        "vpos": _b64(voxels),
        "vcol": _b64(voxel_colors),
        "voxel_size": float(voxel_size),
    }
    # triangle-mesh layer (depth-jump-tested node grids, glviewer.cpp:776)
    if mesh is not None and len(mesh[2]):
        mv, mc, mf = mesh
        data["mpos"] = _b64(np.asarray(mv, np.float32).reshape(-1, 3))
        data["mcol"] = _b64(np.asarray(mc, np.uint8).reshape(-1, 3))
        data["midx"] = _b64(np.asarray(mf, np.uint32).reshape(-1, 3))
    else:
        data["mpos"] = data["mcol"] = data["midx"] = ""
    # per-point sigma splat scales (ellipsoid render mode, glviewer.cpp:922)
    data["sigma"] = (
        _b64(sigmas) if sigmas is not None and len(sigmas) == len(points)
        else ""
    )
    live_js = _LIVE_JS if live else ""
    if controls:
        live_js += _CTL_JS
    return _HTML.format(
        title=title,
        data_json=json.dumps(data),
        live_js=live_js,
        ctl_html=_CTL_HTML if controls else "",
    )


def write_viewer_html(path, *args, **kwargs) -> str:
    html = build_viewer_html(*args, **kwargs)
    Path(path).write_text(html)
    return str(path)
