"""rgbdslam-torch: the PyTorch port's command line.

Port of ``rgbdslam_v2_tpu/apps/cli.py`` (``run``, ``synthetic``, ``ate``,
``rpe``, ``params``, ``vo-multi`` and ``slam-multi``; reference
ros_service_ui.cpp:55-122 and the offline batch evaluation,
openni_listener.cpp:431, test/run_tests.sh):

  run        process a TUM directory, a ROS bag (RGB-D images, or a
             PointCloud2 topic with -p topic_points), a directory of
             PCD/PLY clouds or a rectified stereo directory: trajectory,
             statistics or the 5-level evaluation protocol, landmark
             bundle adjustment, and the clouds, octomap, mesh, g2o graph,
             features and a result bag on request
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

Parameters are repeated ``-p name=value`` (the JAX package's names). The
pipeline runs on the CUDA card unless ``--device cpu`` is given; the multi
commands take ``--devices``: ``auto`` (or ``default``) for every CUDA card,
``cpu:N`` for N CPU shards, and exit with code 2 where there is no card.
Inputs and outputs the port does not have yet exit with code 2 and name the
ROADMAP Queue 1 item that brings them.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# option -> the ROADMAP Queue 1 item that ports it
_UNPORTED_RUN = {"serve": ("--serve", "27b")}


def _unported(option: str, item: str) -> int:
    print(f"rgbdslam-torch: error: {option} is not in the PyTorch port yet "
          f"(ROADMAP Queue 1 item {item})", file=sys.stderr)
    return 2


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
    from ..io.tum import TumDataset, write_trajectory
    from ..pipeline import SlamPipeline

    for key, (option, item) in _UNPORTED_RUN.items():
        if getattr(args, key):
            return _unported(option, item)
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
    online optimize and the 5-level protocol of every sequence, the batched
    counterpart of the reference's per-bag runs (test/run_tests.sh:21-76)."""
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
        # pad shards replay the last sequence; add_frames runs the online
        # optimize on GraphManager's schedule
        ms.add_frames(np.stack(cpts + [cpts[-1]] * pad), np.asarray(ts + [ts[-1]] * pad))
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
    # the JAX CLI's live viewer, not in the port yet
    runp.add_argument("--serve", type=int, default=None, help=argparse.SUPPRESS)
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
