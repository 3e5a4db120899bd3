"""rgbdslam-torch: the PyTorch port's command line.

Port of ``rgbdslam_v2_tpu/apps/cli.py`` (``run`` with ``--serve``,
``synthetic``, ``ate``, ``rpe``, ``params``, ``vo-multi``, ``slam-multi``,
``view`` and ``serve``; reference ros_service_ui.cpp:55-122, the offline
batch evaluation, openni_listener.cpp:431, test/run_tests.sh, and the GL
viewer, glviewer.cpp):

  run        process a TUM directory, a ROS bag (RGB-D images, or a
             PointCloud2 topic with -p topic_points), a directory of
             PCD/PLY clouds or a rectified stereo directory: trajectory,
             statistics or the 5-level evaluation protocol, landmark
             bundle adjustment, and the clouds, octomap, mesh, g2o graph,
             features and a result bag on request; with --serve PORT the
             live WebGL viewer and the run controls over HTTP (pause, step,
             save, param)
  synthetic  write a synthetic RGB-D TUM directory with exact ground truth
             (rendered by the port's renderer), and with --stereo its
             rectified stereo pairs
  ate, rpe   a trajectory file against ground truth
  params     every parameter with its default and doc
  vo-multi   visual odometry of many TUM directories at once, sharded over
             the devices: per-sequence ATE and RANSAC success rate
  slam-multi full SLAM of many TUM directories in lockstep, sharded over the
             devices, and the 5-level protocol of each: trajectory files and
             slam_multi_report.json
  view       PNG orbit renders of a result directory (cloud, trajectory,
             graph edges) and, with --html, the interactive WebGL page
  serve      the WebGL viewer of a result directory over HTTP, reloading
             as a run rewrites it

Parameters are repeated ``-p name=value`` (the JAX package's names). The
pipeline runs on the CUDA card unless ``--device cpu`` is given; the multi
commands take ``--devices``: ``auto`` (or ``default``) for every CUDA card,
``cpu:N`` for N CPU shards, and exit with code 2 where there is no card.
``view`` and ``serve`` are host code (numpy) and never touch the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _cam_from_args(args, params):
    from ..core.camera import TUM_DEFAULT, TUM_FR1, TUM_FR2, Intrinsics

    named = {"fr1": TUM_FR1, "fr2": TUM_FR2, "default": TUM_DEFAULT}
    if args.camera in named:
        cam = named[args.camera]
        # a named calibration scaled to the configured frame size (tpu_image_*)
        tw, th = params["tpu_image_width"], params["tpu_image_height"]
        if (tw, th) != (cam.width, cam.height):
            sx, sy = tw / cam.width, th / cam.height
            cam = Intrinsics(fx=cam.fx * sx, fy=cam.fy * sy, cx=cam.cx * sx, cy=cam.cy * sy,
                             width=tw, height=th)
        return cam
    fx, fy, cx, cy, w, h = (float(x) for x in args.camera.split(","))
    return Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=int(w), height=int(h))


def cmd_run(args) -> int:
    from ..config import ParameterServer
    from ..pipeline import SlamPipeline

    params = ParameterServer.from_cli(args.param or [])
    bagfile = args.bagfile or params["bagfile_name"]
    if not (args.tum_dir or args.pcd_dir or args.stereo_dir or bagfile):
        print("rgbdslam-torch: error: one of --tum-dir, --pcd-dir, --stereo-dir or --bagfile "
              "is required", file=sys.stderr)
        return 2
    cam = _cam_from_args(args, params)
    pipe = SlamPipeline(cam, params, device=args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    pipe.online_octomap_path = str(out / "map_online.ot")
    httpd = None
    if args.serve is not None:
        # the live view and the run controls while SLAM runs (the
        # reference's always-open GL window and GUI actions)
        import socketserver
        import threading

        pipe.live_dir = out
        pipe.live_interval = args.serve_interval
        httpd = socketserver.TCPServer((args.host, args.serve),
                                       make_viewer_handler(out, pipe=pipe))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        print(json.dumps({"serving": str(out),
                          "url": f"http://{args.host}:{httpd.server_address[1]}/"}),
              file=sys.stderr, flush=True)
    try:
        code = _run_and_save(args, params, cam, pipe, out, bagfile)
        if httpd is not None and code == 0:
            pipe._live_refresh(force=True)  # the final state for the live page
            # the page polls every 2 s: serve long enough for the last poll
            # and reload to see the final generation
            time.sleep(3.0)
        return code
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()


def _run_and_save(args, params, cam, pipe, out: Path, bagfile) -> int:
    """cmd_run after the pipeline exists: the input, the protocol or the
    online result, and the outputs asked for."""
    from ..io.tum import TumDataset, write_trajectory

    gt_stamps = gt_xyz = None
    if args.tum_dir:
        ds = TumDataset.open(args.tum_dir)
        pipe.run_tum(ds, max_frames=args.max_frames)
        if ds.groundtruth is not None:
            gt_stamps, gt_xyz = ds.groundtruth[:, 0].tolist(), ds.groundtruth[:, 1:4]
    elif args.pcd_dir:
        # point-cloud files (loadPCDFiles, openni_listener.cpp:1063)
        from ..io.cloud_input import CloudDataset

        pipe.run_clouds(CloudDataset.open(args.pcd_dir, cam), max_frames=args.max_frames)
    elif args.stereo_dir:
        # rectified stereo pairs (stereoCallback, openni_listener.cpp:559-598)
        from ..io.stereo_input import StereoDataset
        from ..io.tum import read_trajectory_file

        pipe.run_stereo(StereoDataset.open(args.stereo_dir), max_frames=args.max_frames)
        gt_file = Path(args.stereo_dir) / "groundtruth.txt"
        if gt_file.exists():
            gt = read_trajectory_file(gt_file)
            gt_stamps, gt_xyz = gt[:, 0].tolist(), gt[:, 1:4]
    elif params["topic_points"]:
        # a PointCloud2 topic in the bag (pcdCallback via topic_points)
        from ..io.rosbag import read_cloud_frames

        pipe.run_clouds(read_cloud_frames(bagfile, params["topic_points"]),
                        max_frames=args.max_frames)
    else:
        pipe.run_bag(bagfile, max_frames=args.max_frames)
        # ground truth from /tf only when a child frame is named: real bags
        # carry calibration transforms on /tf too (ground_truth_frame_name,
        # parameter_server.cpp:75)
        if params["ground_truth_frame_name"]:
            from ..io.rosbag import read_tf_trajectory

            tf_stamps, tf_rows = read_tf_trajectory(
                bagfile, child_frame=params["ground_truth_frame_name"])
            if len(tf_stamps):
                gt_stamps, gt_xyz = tf_stamps.tolist(), tf_rows[:, :3]
    if args.evaluate or params["batch_processing"]:
        report = pipe.evaluation_protocol(out, gt_stamps=gt_stamps, gt_xyz=gt_xyz)
        print(json.dumps(report.as_dict(), indent=2))
    else:
        pipe.manager.optimize()
        stamps, poses = pipe.manager.trajectory()
        write_trajectory(out / "estimate.txt", stamps, poses)
        print(json.dumps(pipe.manager.statistics(), indent=2))
    if args.landmark_ba:
        print(f"landmark BA: {json.dumps(pipe.manager.optimize_landmarks())}")
        stamps, poses = pipe.manager.trajectory()
        write_trajectory(out / "estimate_landmark_ba.txt", stamps, poses)
    if args.save_clouds:
        print(f"saved cloud.pcd ({pipe.save_clouds(out / 'cloud.pcd')} points)")
    if args.save_octomap:
        pipe.save_octomap(out / "map.ot")
        print("saved map.ot")
    if args.save_mesh:
        print(f"saved mesh.ply ({pipe.save_mesh(out / 'mesh.ply')} triangles)")
    if args.save_g2o:
        pipe.save_g2o(out / "graph.g2o")
        print("saved graph.g2o")
    if args.save_features:
        pipe.save_features(out / "features.npz")
        print("saved features.npz")
    if args.save_individual:
        print(f"saved {len(pipe.save_individual_clouds(out / 'clouds'))} per-node clouds")
    if args.save_bag:
        pipe.save_bagfile(out / "result.bag")
        print("saved result.bag")
    return 0


def cmd_synthetic(args) -> int:
    from ..core.camera import TUM_DEFAULT, Intrinsics
    from ..io.synthetic import SyntheticWorld, render_sequence, save_as_tum_dataset

    cam = (Intrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120)
           if args.small else TUM_DEFAULT)
    world = SyntheticWorld.create(seed=args.seed, cam=cam)
    poses, rgbs, depths = render_sequence(world, args.frames, seed=args.seed + 1,
                                          depth_noise_sigma=args.depth_noise,
                                          device=args.device)
    stamps = save_as_tum_dataset(args.out, poses, rgbs, depths)
    if args.stereo > 0:
        from ..io.stereo_input import render_stereo_sequence, save_as_stereo_dataset

        sposes, lefts, rights, _ = render_stereo_sequence(world, args.frames, args.stereo,
                                                          seed=args.seed + 1, device=args.device)
        # the TUM files' stamps: groundtruth.txt, which both share, then
        # holds the stamps of both (the JAX CLI writes the pairs at k / 30 s
        # over the TUM ground truth; ROADMAP F23)
        save_as_stereo_dataset(args.out, sposes, lefts, rights, stamps=stamps)
        print(f"wrote stereo pairs (baseline {args.stereo} m) to {args.out}")
    print(f"wrote {args.frames} frames to {args.out}")
    return 0


def cmd_ate(args) -> int:
    from ..eval.ate import evaluate_ate
    from ..io.tum import read_trajectory_file

    est = read_trajectory_file(args.estimate)
    gt = read_trajectory_file(args.groundtruth)
    res = evaluate_ate(est[:, 0], est[:, 1:4], gt[:, 0], gt[:, 1:4],
                       max_difference=args.max_difference)
    print(json.dumps(res.as_dict(), indent=2))
    return 0


def cmd_rpe(args) -> int:
    """Relative pose error (the benchmark's evaluate_rpe): drift over a
    frame delta, translational [m] and rotational [rad]."""
    from ..eval.ate import evaluate_rpe
    from ..io.tum import associate, read_trajectory_file, rows_to_poses

    est = read_trajectory_file(args.estimate)
    gt = read_trajectory_file(args.groundtruth)
    pairs = sorted(associate(est[:, 0].tolist(), gt[:, 0].tolist(),
                             max_difference=args.max_difference))
    if len(pairs) <= args.delta:
        print("rgbdslam-torch: error: not enough associated pose pairs", file=sys.stderr)
        return 2
    t_err, r_err = evaluate_rpe(rows_to_poses(est[[i for i, _ in pairs]]),
                                rows_to_poses(gt[[j for _, j in pairs]]), delta=args.delta)
    print(json.dumps({"translational_m": t_err.as_dict(), "rotational_rad": r_err.as_dict(),
                      "delta": args.delta, "n_pairs": len(pairs)}, indent=2))
    return 0


def _devices_mesh(spec: str):
    """--devices: "auto" / "default" -> every CUDA card (ValueError where
    there is none); "cpu" or "cpu:N" -> N CPU shards (8 without N)."""
    from ..parallel import candidate_mesh

    if spec.startswith("cpu"):
        return candidate_mesh(int(spec.split(":")[1]) if ":" in spec else 8, platform="cpu")
    if spec not in ("auto", "default"):
        raise ValueError(f"--devices {spec!r}: auto, default, cpu or cpu:N")
    return candidate_mesh(None)


def _tum_frames(args):
    """The TUM directories of a multi command and the frames they share:
    (datasets, T)."""
    from ..io.tum import TumDataset

    datasets = [TumDataset.open(d) for d in args.tum_dirs]
    T = min(len(ds) for ds in datasets)
    if args.max_frames:
        T = min(T, args.max_frames)
    return datasets, T


def cmd_vo_multi(args) -> int:
    """Visual odometry of S sequences at once, one contiguous block of
    sequences a device (parallel/multi_eval.py); per-sequence ATE out."""
    import numpy as np

    from ..config import ParameterServer
    from ..eval.ate import evaluate_ate
    from ..models.orb import OrbExtractor
    from ..parallel.multi_eval import vo_trajectories_sharded

    mesh = _devices_mesh(args.devices)
    params = ParameterServer.from_cli(args.param or [])
    cam = _cam_from_args(args, params)
    datasets, T = _tum_frames(args)
    grays, depths, all_stamps = [], [], []
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    for ds in datasets:
        g, d, st = [], [], []
        for i in range(T):
            ts, rgb, depth = ds.load(i)
            g.append((np.asarray(rgb, np.float32) @ luma) / 255.0)
            d.append(np.asarray(depth, np.float32))
            st.append(ts)
        grays.append(np.stack(g))
        depths.append(np.stack(d))
        all_stamps.append(st)
    n_dev = mesh.size
    S = len(datasets)
    pad = (-S) % n_dev  # pad shards repeat the last sequence
    res = vo_trajectories_sharded(
        mesh, grays + [grays[-1]] * pad, depths + [depths[-1]] * pad, 0,
        OrbExtractor(max_keypoints=params["max_keypoints"]), cam,
        n_hypotheses=params["ransac_iterations"], min_inliers=params["min_matches"],
        sigma_depth=params["sigma_depth"])
    poses = res.poses.cpu().numpy()[:S]
    ok = res.ok.cpu().numpy()
    report = {"devices": n_dev, "sequences": {}}
    for s, ds in enumerate(datasets):
        entry = {"frames": T, "ransac_success_rate": float(ok[s].mean())}
        if ds.groundtruth is not None:
            try:
                entry["ate_rmse"] = evaluate_ate(all_stamps[s], poses[s][:, :3, 3],
                                                 ds.groundtruth[:, 0].tolist(),
                                                 ds.groundtruth[:, 1:4]).rmse
            except ValueError:
                pass
        report["sequences"][str(ds.root)] = entry
    print(json.dumps(report, indent=2))
    return 0


def cmd_slam_multi(args) -> int:
    """Full SLAM of S sequences in lockstep, sharded over the devices
    (parallel/slam_multi.py): the device step, the pose graph with its
    online optimize every optimizer_skip_step frames and the 5-level
    protocol of every sequence, the batched counterpart of the reference's
    per-bag runs (test/run_tests.sh:21-76)."""
    import numpy as np

    from ..config import ParameterServer
    from ..io.tum import write_trajectory
    from ..parallel.slam_multi import MultiSequenceSlam

    mesh = _devices_mesh(args.devices)
    params = ParameterServer.from_cli(args.param or [])
    cam = _cam_from_args(args, params)
    datasets, T = _tum_frames(args)
    n_dev = mesh.size
    S = len(datasets)
    pad = (-S) % n_dev
    ms = MultiSequenceSlam(cam, S + pad, params=params, mesh=mesh if n_dev > 1 else None,
                           device=mesh.devices[0])
    stamps = [[] for _ in range(S)]
    for k in range(T):
        cpts, ts = [], []
        for s, ds in enumerate(datasets):
            t, rgb, depth = ds.load(k)
            stamps[s].append(t)
            cpts.append(ms.compact(rgb, depth))
            ts.append(t)
        # pad shards replay the last sequence
        ms.add_frames(np.stack(cpts + [cpts[-1]] * pad), np.asarray(ts + [ts[-1]] * pad))
        if (k + 1) % params["optimizer_skip_step"] == 0:  # the JAX CLI's schedule
            ms.optimize(iterations=params["online_optimizer_iterations"], blocking=False)
    gt_stamps = gt_xyz = None
    if all(ds.groundtruth is not None for ds in datasets):
        gt_stamps = [ds.groundtruth[:, 0].tolist() for ds in datasets]
        gt_xyz = [ds.groundtruth[:, 1:4] for ds in datasets]
        gt_stamps += [gt_stamps[-1]] * pad
        gt_xyz += [gt_xyz[-1]] * pad
    levels, ate = ms.evaluation_protocol(gt_stamps=gt_stamps, gt_xyz=gt_xyz)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"devices": n_dev, "frames": T, "sequences": {}}
    stats = ms.statistics()
    for s, ds in enumerate(datasets):
        name = f"seq{s}_" + (Path(str(ds.root)).name or "")
        for level, poses in levels.items():
            write_trajectory(out / f"{name}_estimate_iteration_{level}.txt", stamps[s], poses[s])
        entry = dict(stats[s])
        if ate:
            entry["ate_rmse"] = {str(lv): float(ate[lv][s]) for lv in sorted(ate)}
        report["sequences"][name] = entry
    (out / "slam_multi_report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return 0


def _g2o_edge_pairs(path: Path) -> list:
    """The (i, j) of a g2o file's EDGE_SE3:QUAT lines, read as text."""
    out = []
    for line in path.read_text().splitlines():
        parts = line.split()
        if parts and parts[0] == "EDGE_SE3:QUAT":
            out.append((int(parts[1]), int(parts[2])))
    return out


def _load_result_dir(root: Path, require_cloud: bool = True):
    """A result directory's cloud, trajectory and graph edges for viewing:
    (points, colors, traj (T, 4, 4) or None, edges or None); numpy only.
    FileNotFoundError without cloud.pcd, unless require_cloud is False (the
    live view starts from the trajectory and edges alone); then only when
    nothing viewable exists yet."""
    import numpy as np

    from ..io.pointcloud import read_pcd
    from ..io.tum import read_trajectory_file, rows_to_poses

    cloud = root / "cloud.pcd"
    if cloud.exists():
        points, colors = read_pcd(cloud)
    elif require_cloud:
        raise FileNotFoundError(f"{cloud} not found (run with --save-clouds)")
    else:
        points = np.zeros((0, 3), np.float32)
        colors = np.zeros((0, 3), np.uint8)
    traj = edges = None
    # the freshest estimate file (mtime): a live run rewrites estimate.txt
    # while an earlier run's estimate_iteration_4.txt may stay in a reused
    # directory; after a protocol run the level-4 file is the newest
    cands = [root / n for n in ("estimate_iteration_4.txt", "estimate.txt")]
    cands = sorted((p for p in cands if p.exists()), key=lambda p: p.stat().st_mtime_ns,
                   reverse=True)
    if cands:
        traj = rows_to_poses(read_trajectory_file(cands[0]))
    if (root / "graph.g2o").exists():
        edges = _g2o_edge_pairs(root / "graph.g2o")
    if not require_cloud and len(points) == 0 and traj is None:
        raise FileNotFoundError(f"nothing viewable in {root} yet (no cloud.pcd / estimate*.txt)")
    return points, colors, traj, edges


def cmd_view(args) -> int:
    """Offline views of a saved result (the GL viewer, glviewer.cpp,
    rendered headless by io/render3d.py) and, with --html, the interactive
    WebGL page (io/viewer_html.py), with the octomap, mesh and sigma
    layers where their files exist. Host code only."""
    import numpy as np

    from ..io.render3d import render_orbit_views

    root = Path(args.result_dir)
    try:
        points, colors, traj, edges = _load_result_dir(root)
    except FileNotFoundError as exc:
        print(f"rgbdslam-torch: error: {exc}", file=sys.stderr)
        return 2
    out_json = {}
    if args.html is not None:
        from ..io.viewer_html import write_viewer_html

        vox = vox_cols = None
        vox_res = 0.05
        if (root / "map.ot").exists():
            # the octomap layer (the GL viewer's renderable octomap)
            from ..mapping.octree_io import read_color_octree

            vox, probs, vox_cols, vox_res = read_color_octree(root / "map.ot")
            occ = probs > 0.5
            vox, vox_cols = vox[occ], vox_cols[occ]
        mesh = None
        if (root / "mesh.ply").exists():
            # the triangle-mesh layer (run --save-mesh; glviewer.cpp:776)
            from ..io.meshing import read_ply_mesh

            mesh = read_ply_mesh(root / "mesh.ply")
        sigmas = None
        if traj is not None and len(traj) and len(points):
            # sigma ellipsoid mode (glviewer.cpp:922): the splat size from
            # the quadratic depth-noise model at each point's distance to
            # the nearest of 64 camera poses (sigma_depth * z^2)
            centers = np.asarray(traj)[:: max(1, len(traj) // 64), :3, 3]
            z = np.full(len(points), np.inf, np.float32)
            for i in range(0, len(points), 65536):
                d = np.linalg.norm(points[i:i + 65536, None, :] - centers[None], axis=-1)
                z[i:i + 65536] = d.min(1)
            sigmas = (0.01 * z * z).astype(np.float32)
        out_json["html"] = write_viewer_html(
            args.html or str(root / "viewer.html"), points, colors, traj=traj, edges=edges,
            title=root.name or "rgbdslam map", voxels=vox, voxel_colors=vox_cols,
            voxel_size=vox_res, mesh=mesh, sigmas=sigmas)
    if args.views > 0:
        w, h = (int(x) for x in args.size.split("x"))
        out_json["views"] = render_orbit_views(
            points, colors, Path(args.out) if args.out else root / "views", traj=traj,
            edges=edges, n_views=args.views, size=(w, h))
    print(json.dumps(out_json))
    return 0


def make_viewer_handler(root: Path, pipe=None):
    """The live viewer's HTTP handler class for serve and run --serve: GET
    / (the page, or a waiting page while nothing is viewable), /gen (the
    newest output's mtime), /frame.png and /depth.png; with a pipeline,
    POST /ctl/pause, /ctl/step, /ctl/save and /ctl/param?name=k&value=v
    (the reference's pause, getOneFrame and save signals,
    openni_listener.cpp:119-120, and its setParam dialog).

    The handler thread makes no CUDA call. The controls flip the
    pipeline's host flags and write its parameter dict; the page is built
    from root's files with numpy readers. The run loop's thread may be
    capturing a CUDA graph (torch.cuda.graph, global capture mode), which a
    CUDA call from another thread (an allocation, pinned memory, a
    synchronization) would break, so all device work stays there."""
    import http.server

    def generation() -> int:
        # nanosecond mtimes: two refreshes within one second (the final
        # forced one) still move the generation the page polls
        gen = 0
        for name in ("cloud.pcd", "estimate.txt", "estimate_iteration_4.txt", "graph.g2o",
                     "frame.png"):
            p = root / name
            if p.exists():
                gen = max(gen, p.stat().st_mtime_ns)
        return gen

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path.rstrip("/") in ("", "/viewer.html"):
                from ..io.viewer_html import build_viewer_html

                try:
                    points, colors, traj, edges = _load_result_dir(root, require_cloud=False)
                except Exception as exc:  # nothing yet, or a partial write
                    self._send((f"<html><body><h3>waiting for results…</h3><p>{exc}</p>"
                                "<script>setTimeout(()=>location.reload(),2000)</script>"
                                "</body></html>").encode(), "text/html; charset=utf-8")
                    return
                self._send(build_viewer_html(
                    points, colors, traj=traj, edges=edges, title=root.name or "rgbdslam map",
                    live=True, controls=pipe is not None, generation=generation()).encode(),
                    "text/html; charset=utf-8")
            elif path.endswith("/gen"):
                self._send(str(generation()).encode(), "text/plain")
            elif path.endswith(("/frame.png", "/depth.png")):
                p = root / path.rsplit("/", 1)[1]
                if p.exists():
                    self._send(p.read_bytes(), "image/png")
                else:
                    self.send_error(404)
            else:
                self.send_error(404)

        def do_POST(self):
            if pipe is None or not self.path.startswith("/ctl/"):
                self.send_error(409 if pipe is None else 404)
                return
            action = self.path[len("/ctl/"):].split("?")[0].rstrip("/")
            if action == "pause":
                msg = "paused" if pipe.toggle_pause() else "running"
            elif action == "step":
                pipe.get_one_frame()
                msg = "stepping one frame"
            elif action == "save":
                pipe.request_live_save()
                msg = "cloud save queued"
            elif action == "param":
                # live parameter editing (the GUI's setParam dialog and the
                # reload_config service, qt_gui.cpp:406-478,
                # ros_service_ui.cpp:67)
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                name = (q.get("name") or [""])[0]
                if not name or "value" not in q:
                    self.send_error(400, "need name= and value=")
                    return
                try:
                    val = pipe.set_param(name, q["value"][0])
                except KeyError:
                    self.send_error(400, f"unknown parameter {name}")
                    return
                msg = f"{name}={val}"
            else:
                self.send_error(404)
                return
            self._send(json.dumps({"status": msg}).encode(), "application/json")

    return Handler


def cmd_serve(args) -> int:
    """Serve the viewer of a result directory over HTTP with live reload
    (the reference's GL window open during a run, glviewer.cpp): a run that
    saves its results there makes the page reload within ~2 s."""
    import socketserver

    root = Path(args.result_dir)
    with socketserver.TCPServer((args.host, args.port), make_viewer_handler(root)) as httpd:
        print(json.dumps({"serving": str(root),
                          "url": f"http://{args.host}:{httpd.server_address[1]}/"}), flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


def cmd_params(args) -> int:
    from ..config import PARAM_DEFS

    for d in PARAM_DEFS:
        print(f"{d.name:36s} {d.default!r:14} {d.doc}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rgbdslam-torch", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run SLAM on a TUM directory, a ROS bag or PCD/PLY files")
    runp.add_argument("--tum-dir", default=None)
    runp.add_argument("--bagfile", default=None,
                      help="ROS bag input (or -p bagfile_name); -p topic_points reads a "
                           "PointCloud2 topic instead of the image topics")
    runp.add_argument("--pcd-dir", default=None, help="directory of .pcd/.ply clouds")
    runp.add_argument("--stereo-dir", default=None,
                      help="directory with left/ and right/ rectified image pairs; block-matching "
                           "depth on the device (-p stereo_baseline=... metres)")
    runp.add_argument("--out", required=True)
    runp.add_argument("--camera", default="default", help="fr1|fr2|default or fx,fy,cx,cy,w,h")
    runp.add_argument("--max-frames", type=int, default=None)
    runp.add_argument("-p", "--param", action="append", metavar="K=V")
    runp.add_argument("--evaluate", action="store_true",
                      help="run the 5-level evaluation protocol")
    runp.add_argument("--save-clouds", action="store_true")
    runp.add_argument("--save-octomap", action="store_true")
    runp.add_argument("--save-mesh", action="store_true",
                      help="triangle-mesh the node grids (depth-jump test) into mesh.ply")
    runp.add_argument("--save-g2o", action="store_true")
    runp.add_argument("--save-features", action="store_true")
    runp.add_argument("--save-individual", action="store_true",
                      help="one cloud file per node (saveIndividualClouds)")
    runp.add_argument("--save-bag", action="store_true",
                      help="the trajectory as /tf in result.bag (saveBagfile)")
    runp.add_argument("--landmark-ba", action="store_true",
                      help="refine with landmark bundle adjustment into "
                           "estimate_landmark_ba.txt (DO_FEATURE_OPTIMIZATION)")
    runp.add_argument("--device", default=None,
                      help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    runp.add_argument("--serve", type=int, default=None, metavar="PORT",
                      help="serve the live WebGL viewer and the run controls "
                           "(pause/step/save/param) on PORT while running (0: any free port)")
    runp.add_argument("--serve-interval", type=int, default=30, metavar="FRAMES",
                      help="frames between live-view output refreshes")
    runp.add_argument("--host", default="127.0.0.1",
                      help="bind address for --serve (default localhost; the control "
                           "endpoints are unauthenticated)")
    runp.set_defaults(fn=cmd_run)

    synp = sub.add_parser("synthetic", help="generate a synthetic TUM dataset")
    synp.add_argument("--out", required=True)
    synp.add_argument("--frames", type=int, default=60)
    synp.add_argument("--seed", type=int, default=0)
    synp.add_argument("--depth-noise", type=float, default=0.0)
    synp.add_argument("--small", action="store_true", help="160x120 frames")
    synp.add_argument("--device", default=None,
                      help="render device (default: the CUDA card; 'cpu' to render on the CPU)")
    synp.add_argument("--stereo", type=float, default=0.0, metavar="BASELINE",
                      help="also write rectified stereo pairs (left/ and right/) with this "
                           "baseline in metres")
    synp.set_defaults(fn=cmd_synthetic)

    for name, fn, doc in (("ate", cmd_ate, "evaluate a trajectory against ground truth"),
                          ("rpe", cmd_rpe, "relative pose error against ground truth")):
        sp = sub.add_parser(name, help=doc)
        sp.add_argument("estimate")
        sp.add_argument("groundtruth")
        if name == "rpe":
            sp.add_argument("--delta", type=int, default=1,
                            help="frame delta for relative motions")
        sp.add_argument("--max-difference", type=float, default=0.02)
        sp.set_defaults(fn=fn)

    sub.add_parser("params", help="list parameters").set_defaults(fn=cmd_params)

    vmp = sub.add_parser("vo-multi",
                         help="sharded multi-sequence visual odometry (sequences over devices)")
    vmp.add_argument("tum_dirs", nargs="+")
    vmp.add_argument("--devices", default="default",
                     help="'default' / 'auto' (every CUDA card) or 'cpu:N' CPU shards")
    vmp.add_argument("--camera", default="default")
    vmp.add_argument("--max-frames", type=int, default=None)
    vmp.add_argument("-p", "--param", action="append", metavar="K=V")
    vmp.set_defaults(fn=cmd_vo_multi)

    smp = sub.add_parser("slam-multi",
                         help="multi-sequence FULL SLAM in lockstep (graph + loop closures + "
                              "5-level protocol), sharded over the devices")
    smp.add_argument("tum_dirs", nargs="+")
    smp.add_argument("--out", default="slam_multi_out")
    smp.add_argument("--devices", default="auto",
                     help="'auto' / 'default' (every CUDA card) or 'cpu:N' CPU shards")
    smp.add_argument("--camera", default="default")
    smp.add_argument("--max-frames", type=int, default=None)
    smp.add_argument("-p", "--param", action="append", metavar="K=V")
    smp.set_defaults(fn=cmd_slam_multi)

    viewp = sub.add_parser("view",
                           help="render a result dir (cloud + trajectory + edges) to PNGs")
    viewp.add_argument("result_dir", help="directory with cloud.pcd / estimate*.txt / graph.g2o")
    viewp.add_argument("--out", default=None, help="output dir (default: <result_dir>/views)")
    viewp.add_argument("--views", type=int, default=6,
                       help="number of PNG orbit views (0: skip PNGs)")
    viewp.add_argument("--size", default="960x720")
    viewp.add_argument("--html", nargs="?", const="", default=None, metavar="PATH",
                       help="also write the interactive WebGL viewer "
                            "(default: <result_dir>/viewer.html)")
    viewp.set_defaults(fn=cmd_view)

    servep = sub.add_parser("serve", help="serve the interactive 3D viewer with live reload "
                                          "(the GL window during a run, in a browser)")
    servep.add_argument("result_dir", help="result dir to watch (cloud.pcd + estimate*.txt)")
    servep.add_argument("--port", type=int, default=8765)
    servep.add_argument("--host", default="127.0.0.1", help="bind address (default localhost)")
    servep.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError, KeyError) as exc:
        print(f"rgbdslam-torch: error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
