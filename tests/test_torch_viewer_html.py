"""The port's WebGL viewer and its HTTP surface against the JAX package's.

* build_viewer_html: the same page, byte for byte, for the same inputs, in
  each layer combination (cloud, trajectory and edges, the subsampling,
  the octomap, the mesh and sigma layers, the live and control scripts).
* The handler (apps/cli.make_viewer_handler) over a real socket: the
  waiting page, then the viewer page equal to the JAX handler's on the
  same directory, /gen, 404s; rgbdslam-torch serve answers GET /.
* run --serve's controls (tests/test_viewer_html.py:152-322 in the JAX
  package): the same HTTP control sequences (pause, step, save, param)
  drive a port pipeline and a JAX pipeline on the same JAX-rendered 80x60
  frames; the frames dropped, processed and entered, the candidate edges
  and their accept decisions are equal, and the live outputs appear.
  /ctl/param raises observability_threshold to 1.0 mid-run: every later
  decision is a rejection in both, each node entering by its
  constant-position edge.
"""
import json
import re
import socketserver
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

pytest.importorskip("jax")
from rgbdslam_v2_tpu.apps import cli as jcli  # noqa: E402
from rgbdslam_v2_tpu.config import ParameterServer as JParams  # noqa: E402
from rgbdslam_v2_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbdslam_v2_tpu.io import SyntheticWorld as JWorld  # noqa: E402
from rgbdslam_v2_tpu.io import render_sequence as jrender  # noqa: E402
from rgbdslam_v2_tpu.io.viewer_html import build_viewer_html as jbuild  # noqa: E402
from rgbdslam_v2_tpu.pipeline import SlamPipeline as JPipeline  # noqa: E402
from rgbdslam_v2_tpu_torch.apps import cli  # noqa: E402
from rgbdslam_v2_tpu_torch.config import ParameterServer  # noqa: E402
from rgbdslam_v2_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION  # noqa: E402
from rgbdslam_v2_tpu_torch.io.pointcloud import write_pcd  # noqa: E402
from rgbdslam_v2_tpu_torch.io.png import read_png  # noqa: E402
from rgbdslam_v2_tpu_torch.io.viewer_html import build_viewer_html, write_viewer_html  # noqa: E402
from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline  # noqa: E402
from test_torch_native_compact import jax_native_encoder  # noqa: E402,F401

CAM = (65.0, 65.0, 40.0, 30.0, 80, 60)
# the JAX tests' parameters (tests/test_viewer_html.py:172-176, 246-250),
# one set for both runs, so the JAX package compiles its step once
PARAMS = dict(max_keypoints=64, tpu_max_nodes=16, tpu_max_edges=64, tpu_candidate_batch=2,
              ransac_iterations=32, min_matches=8, keep_all_nodes=True,
              observability_threshold=0.5)


def _layers(name):
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (700, 3), dtype=np.uint8)
    traj = np.tile(np.eye(4, dtype=np.float32), (9, 1, 1))
    traj[:, 0, 3] = np.arange(9) * 0.1
    traj[:, 2, 3] = np.sin(np.arange(9))
    base = dict(points=pts, colors=cols)
    return {
        "cloud": base,
        "gray cloud": dict(points=pts, colors=None, title="t3"),
        "trajectory": dict(base, traj=traj, edges=[(0, 4), (1, 2), (2, 8), (3, 20)],
                           axis_every=2),
        "subsampled": dict(base, max_points=300, sigmas=np.abs(pts[:, 2])),
        "voxels": dict(points=np.zeros((0, 3), np.float32),
                       voxels=rng.normal(size=(50, 3)).astype(np.float32),
                       voxel_colors=rng.integers(0, 256, (50, 3), dtype=np.uint8),
                       voxel_size=0.02, max_voxels=30),
        "mesh and sigmas": dict(base, traj=traj, mesh=(
            pts[:30], cols[:30], rng.integers(0, 30, (20, 3)).astype(np.int64)),
            sigmas=np.full(700, 0.01, np.float32)),
        "live with controls": dict(base, traj=traj, live=True, controls=True,
                                   generation=1234567890123),
        "empty": dict(points=np.zeros((0, 3), np.float32)),
    }[name]


@pytest.mark.parametrize("name", ["cloud", "gray cloud", "trajectory", "subsampled", "voxels",
                                  "mesh and sigmas", "live with controls", "empty"])
def test_build_viewer_html_equals_jax(name):
    kw = _layers(name)
    page = build_viewer_html(**kw)
    assert page == jbuild(**kw)
    assert page.startswith("<!DOCTYPE html>") and "const DATA = " in page
    assert ("function poll" in page) == bool(kw.get("live"))
    assert ("bPause" in page) == bool(kw.get("controls"))


def test_write_viewer_html(tmp_path):
    kw = _layers("trajectory")
    assert write_viewer_html(tmp_path / "v.html", **kw) == str(tmp_path / "v.html")
    assert (tmp_path / "v.html").read_text() == jbuild(**kw)


@contextmanager
def _served(handler):
    with socketserver.TCPServer(("127.0.0.1", 0), handler) as httpd:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            yield f"http://127.0.0.1:{httpd.server_address[1]}"
        finally:
            httpd.shutdown()


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read()


def _post(url):
    req = urllib.request.Request(url, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


def _status(fn, url):
    try:
        fn(url)
    except urllib.error.HTTPError as exc:
        return exc.code
    return 200


def test_serve_handler_http_roundtrip(tmp_path):
    with _served(cli.make_viewer_handler(tmp_path)) as url:
        assert b"waiting for results" in _get(f"{url}/")
        pts = np.array([[0, 0, 1], [0.1, 0, 1.2], [0, 0.1, 0.9]], np.float32)
        write_pcd(tmp_path / "cloud.pcd", pts, np.full((3, 3), 200, np.uint8))
        (tmp_path / "estimate.txt").write_text(
            "0.0 0 0 0 0 0 0 1\n1.0 0.1 0 0 0 0.0998 0 0.995\n2.0 0.2 0 0.1 0 0 0 1\n")
        (tmp_path / "graph.g2o").write_text("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
                                            "EDGE_SE3:QUAT 0 2 0 0 0 0 0 0 1 "
                                            + " ".join(["1"] * 21) + "\n")
        body = _get(f"{url}/viewer.html")
        assert b"webgl" in body and b"DATA" in body and b"poll()" in body
        gen = int(_get(f"{url}/gen"))
        assert gen > 0 and f'"gen": {gen}'.encode() in body
        with _served(jcli.make_viewer_handler(tmp_path)) as jurl:
            assert _get(f"{jurl}/") == _get(f"{url}/")  # the same page from the same files
        assert _status(_get, f"{url}/nope") == 404
        assert _status(_get, f"{url}/frame.png") == 404  # no pane yet
        assert _status(_post, f"{url}/ctl/pause") == 409  # no pipeline behind serve


def test_cli_serve_answers(tmp_path, monkeypatch):
    """rgbdslam-torch serve (cmd_serve on a thread, port 0): the server it
    starts answers GET / with the live page and /gen with its generation."""
    write_pcd(tmp_path / "cloud.pcd", np.array([[0, 0, 1], [1, 1, 2]], np.float32),
              np.array([[10, 20, 30], [40, 50, 60]], np.uint8))
    started = {"ready": threading.Event()}

    class Recorded(socketserver.TCPServer):
        def serve_forever(self, *a, **kw):
            started["srv"] = self
            started["ready"].set()
            super().serve_forever(poll_interval=0.05)

    monkeypatch.setattr(socketserver, "TCPServer", Recorded)
    args = cli.build_parser().parse_args(["serve", str(tmp_path), "--port", "0"])
    th = threading.Thread(target=args.fn, args=(args,), daemon=True)
    th.start()
    assert started["ready"].wait(10)
    try:
        url = f"http://127.0.0.1:{started['srv'].server_address[1]}"
        page = _get(f"{url}/")
        assert b"const DATA" in page and b"function poll" in page
        assert f'"gen": {int(_get(f"{url}/gen"))}'.encode() in page
    finally:
        started["srv"].shutdown()
    th.join(10)
    assert not th.is_alive()


@pytest.fixture(scope="module")
def frames():
    """The JAX test's 6 frames: world 0 (texture 128), orbit seed 1, 80x60."""
    world = JWorld.create(seed=0, texture_size=128, cam=JIntrinsics(*CAM))
    poses, rgbs, depths = jrender(world, 6, seed=1)
    return np.asarray(poses), np.asarray(rgbs), np.asarray(depths)


def _edges(mgr):
    """(candidate pair, accepted or constant-position, type) of each edge
    slot of a drained manager, in slot order."""
    h = getattr(mgr, "host", mgr)
    active = h.edge_active if hasattr(h, "edge_active") else h.edge_active_host
    return [(pair, bool(active[e]), h.edge_types[e]) for e, pair in enumerate(h.edge_pairs)
            if pair is not None]


def _controlled_run(package, root, frames, script):
    """A pipeline of `package` ("jax" or "torch") with its viewer handler
    mounted on root and live_dir = root (live_interval 2), driven by
    `script`: a list of ("post", action) and ("frame", k) steps, each
    frame with its ground-truth pose while the graph is empty. Returns
    (the pipeline, the results of the steps)."""
    poses, rgbs, depths = frames
    if package == "jax":
        pipe, handler = JPipeline(JIntrinsics(*CAM), JParams(dict(PARAMS))), jcli
    else:
        pipe = SlamPipeline(Intrinsics(*CAM), ParameterServer(dict(PARAMS)), device="cpu")
        handler = cli
    pipe.live_dir, pipe.live_interval = root, 2
    out = []
    with _served(handler.make_viewer_handler(root, pipe=pipe)) as url:
        for kind, arg in script:
            if kind == "post":
                try:
                    out.append(_post(f"{url}/ctl/{arg}")["status"])
                except urllib.error.HTTPError as exc:
                    out.append(exc.code)
            else:
                gt = poses[arg] if pipe.manager.n_nodes == 0 else None
                out.append(pipe.process_frame(rgbs[arg], depths[arg], arg / 30.0, gt_pose=gt))
        pipe._live_refresh(force=True)
        pipe.manager._drain_pending()
        out.append(_get(f"{url}/"))
        for name in ("frame.png", "depth.png"):
            out.append(_get(f"{url}/{name}?g=1"))
    return pipe, out


CONTROLS = [("post", "pause"), ("frame", 0), ("post", "step"), ("frame", 0), ("frame", 1),
            ("post", "pause"), ("post", "save"), *(("frame", k) for k in range(1, 6))]


def test_live_run_serve_controls(tmp_path, frames):
    """Pause, step, resume and save over HTTP: the port's pipeline and the
    JAX package's drop and process the same frames and build the same
    graph; the live outputs appear and the page carries the controls."""
    runs = {pkg: _controlled_run(pkg, tmp_path / pkg, frames, CONTROLS)
            for pkg in ("jax", "torch")}
    (jp, jout), (tp, tout) = runs["jax"], runs["torch"]
    n = len(CONTROLS)
    assert tout[:n] == jout[:n] == ["paused", False, "stepping one frame", True, False,
                                    "running", "cloud save queued", True, True, True, True, True]
    assert (tp.n_processed, tp.n_dropped, tp.manager.n_nodes) == (
        jp.n_processed, jp.n_dropped, jp.manager.n_nodes) == (6, 0, 6)
    assert _edges(tp.manager) == _edges(jp.manager)
    assert not tp.paused and not tp._live_save_requested
    root = tmp_path / "torch"
    for name in ("estimate.txt", "graph.g2o", "cloud.pcd", "frame.png", "depth.png"):
        assert (root / name).is_file(), name
    page, frame_png, depth_png = tout[n:]
    assert b"bPause" in page and b"ctl(" in page and b"bParam" in page
    assert b"frame.png" in page and b"depth.png" in page and b"DATA" in page
    for png in (frame_png, depth_png):
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert read_png(root / "frame.png").shape == read_png(root / "depth.png").shape == (60, 80, 3)
    assert len(cli._load_result_dir(root)[2]) == 6  # the trajectory the page draws


def test_live_param_endpoint_changes_acceptance(tmp_path, frames):
    """/ctl/param (the GUI's setParam, reload_config): an unknown name is a
    400; observability_threshold=1.0 after frame 2 turns every later
    decision into a rejection, in both packages alike."""
    script = [*(("frame", k) for k in range(3)), ("post", "param?name=bogus&value=1"),
              ("post", "param?name=observability_threshold&value=1.0"),
              *(("frame", k) for k in range(3, 6))]
    runs = {pkg: _controlled_run(pkg, tmp_path / pkg, frames, script)
            for pkg in ("jax", "torch")}
    (jp, jout), (tp, tout) = runs["jax"], runs["torch"]
    assert tout[:len(script)] == jout[:len(script)] == [
        True, True, True, 400, "observability_threshold=1.0", True, True, True]
    assert tp.params["observability_threshold"] == 1.0
    edges = _edges(tp.manager)
    assert edges == _edges(jp.manager)
    assert any(on and pair[1] <= 2 and t != EDGE_CONST_POSITION for pair, on, t in edges)
    for new_id in (3, 4, 5):  # every later candidate rejected, the fallback taken
        mine = [(on, t) for pair, on, t in edges if pair[1] == new_id and on]
        assert mine == [(True, EDGE_CONST_POSITION)], (new_id, mine)
    assert re.search(rb'"gen": [1-9]', tout[len(script)])
