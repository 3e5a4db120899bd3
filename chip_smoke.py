#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rgbdslam_v2_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py [--frames N]

Phases, each printing one or more lines; any failed check exits non-zero
and prints no result:
  1. device and build: the card's name and power limit (nvidia-smi), torch
     and CUDA versions, and the time to build csrc/detect_corners.cu and
     csrc/kabsch.cu (one nvcc a source; kabsch.cu holds the Kabsch and the
     RANSAC refine kernels), the host wire encoder
     native/compact_ingest.cpp and the PNG row unfilter
     csrc/png_unfilter.cpp (g++ -O3 -ffp-contract=off, or nvcc -x c++
     without g++; the compiler is printed), all started together;
  2. kernel against plain: the one-launch detect kernel on the four pyramid
     levels of a 640x480 frame the port renders, against its plain torch
     version on each level, at thresholds 0.06, 0.015 and 0.001875 (the
     adaptive detector's highest, middle and lowest): equal corner masks
     and max abs error 0.0, or it fails. Then its time at 480x640 (level 0
     alone) and for the frame (four levels, one launch): the mean device
     time of the kernel over 20 calls from a torch.profiler trace, the
     median of 20 CUDA-event spans around the call (host dispatch
     included), the same for the plain version, and the bound (bytes read
     and written at 3.35 TB/s, or float operations at 67 TFLOP/s, the
     larger) with the kernel's share of it; and the device time of the
     whole detect stage of a frame, the pyramid's resizes included. The
     Kabsch kernel against its plain version (torch.linalg.svd + det, run
     in float64 on the same inputs; its float32 difference is printed too)
     on 1000 random well-conditioned problems at N = 64 and at N = 300 (R
     within KABSCH_TOL, t within KABSCH_TOL m), all-zero weights (R = I, t
     = 0) and collinear points (a proper rotation); then its device time at
     the main path's shape (8 candidates x 300 matches) beside the plain
     version's and beside torch.linalg.svd + det of the same 8 matrices,
     and its bound. The RANSAC refine kernel (refine_iterations=4 refits,
     max_mahal_sq=9, one launch for all candidates) against its plain
     version run in float64 on the same inputs, on 512 and on 8 candidates
     of 300 matches (refine_problems): T within KABSCH_TOL, inlier masks
     equal except at matches whose float64 m2 lies within 1e-4 x
     max_mahal_sq of the threshold in one of the gates (counted; n_inliers
     may differ by that count), rmse within REFINE_RMSE_RTOL; its float32
     difference is printed too; a candidate with no valid match and one
     with zero weights equal to the plain version; then its device time at
     the main path's shape (8 x 300, 4 refits) beside the plain version's
     and the old route's (one Kabsch kernel launch a refit plus the torch
     gate ops), the old route's device ops, and the bound;
  3. main path: the bench sequence (orbit in the synthetic room, 640x480,
     depth noise 0.01 z^2 with 1/5000 m quantization) rendered on the card;
     the ydct luma decode on the card against the numpy decoder on its
     first 20 frames at quality 2.7 (equal, or at most 1 grey level apart,
     or it fails); its first MAIN_FRAMES (260) frames
     run through SlamPipeline(device="cuda") in the keep-all configuration
     (ORB-600 over 4 levels, 8 candidates, RANSAC-200, EMM on); prints fps
     over the frames after the 20 warm-up frames, the graph statistics and
     the detect kernel's launch count, which must equal the frames
     processed (one launch a frame), the refine kernel's, which must be
     one a frame after the first, and the Kabsch kernel's, which must be 0
     (the step no longer launches it), and the host encodes by route
     (native or numpy);
  4. protocol: the 5-level evaluation protocol, ATE L0..L4 against the exact
     ground truth; L4 must be at most 0.03 m;
  5. default configuration: SlamPipeline(TUM_DEFAULT, default_params(),
     device="cuda") unchanged (ORB-600 over 4 levels, 8 candidates,
     RANSAC-200, observability_threshold=0, the host-decision path with
     motion gates and keyframes, online PCG optimize of every node: 3 LM x
     24 CG iterations; 4096-node / 65536-edge capacity) on the first
     DEFAULT_FRAMES (150) frames of the same sequence, 20 warm-up frames;
     prints
     fps, the graph (nodes, dropped frames, sequential / loop /
     constant-position edges, keyframes), detect launches a frame (must be
     1), refine launches (one a frame after the first) and Kabsch launches
     (0), the median ms of one online optimize (host clock, synchronized),
     peak device memory and the protocol's ATE L0..L4 (finite, L4 at most
     DEFAULT_ATE_L4_MAX), and fails if any optimize used the dense solver.
  6. bench configuration: bench.py's make_pipe parameters exactly as it
     sets them (make_pipe_params: ydct 2.7 luma, 10-bit depth, 4 frames a
     step replayed as CUDA graphs, encode-ahead, pipelined drains,
     inaffected online optimize every 10 frames) on the same sequence, 20
     warm-up frames one at a time as bench.py feeds them, then the rest
     through run_arrays: fps, the graph (nodes, active edges,
     constant-position edges), detect launches (must equal the frames),
     refine launches (one a frame after the first), Kabsch launches (0),
     CUDA graphs
     captured, eager warm-up groups and replays, synchronizing calls
     (torch.cuda.set_sync_debug_mode) in the timed groups that only
     replayed (must be 0) and in those that warmed up or captured a graph,
     the waits for a copy that had not landed in replayed groups and
     those of them that left the card with no step queued (must be 0: the
     drains pipeline),
     the host encodes by route (numpy must be 0), peak device memory, and
     the protocol's ATE L0..L4 (L4 at most 0.03 m);
  7. grouped equality: make_pipe_params with 4 candidates (the 4
     predecessors, so candidates do not depend on when drains land) and no
     online optimize, 4 frames a step replayed against 1 frame a step
     eager, on the first 60 frames: trajectories within 1e-6, equal graph
     statistics, and at least one replay, or it fails;
  8. the host wire encoder on the bench frames (host only, stride 2,
     10-bit depth): native yc12 bytes equal numpy's on every frame; native
     ydct 2.7 codes within 1 of numpy's (their share printed), the card's
     decode of the native wire within 1 grey level of numpy's decode of
     it, and the two wires' decodes apart only as far as the differing
     codes move the pixels; encode ms a frame by route (median, IQR);
  9. fr2 scale (bench.py:361-415): make_pipe(4096, 65536) over the bench
     frames 4 times, 20 warm-up frames, each round through run_arrays:
     fps per round with the node count, detect launches (= frames) and
     refine launches (= frames - 1), graphs captured, replays, the
     synchronizing calls in replayed groups (must be 0) and the waits there
     for copies not landed (none may leave the card idle), peak memory, then
     the final blocking optimize with pose_relative_to=first (ms, LM
     iterations, chi2, solver); fails on non-finite poses or chi2 or a
     node count other than 4 x frames;
 10. spin360 (bench.py:418-492): spin_trajectory(260, seed=2, 3
     deg/frame) rendered at 640x480 on the card and run as phase 6 runs
     the bench frames: fps, ATE L0..L4 (L1 at most SPIN_L1_MAX), graph,
     constant-position edges, GICP rescues, launches, 0 syncs in replayed
     groups and no wait that leaves the card idle;
 11. the hard sequences of tools/hard_sequences.py at 640x480, 300 frames
     each (low_texture, depth_holes, dark_stretch), run as phase 6 with
     use_icp=True: ATE L0..L4, constant-position edges, GICP rescues and
     items sent, fps, the device ms of one retroactive rescue item and of
     one ICP distance matrix + row minimum, and per replayed group its
     synchronizing calls against its blocking drain copies (starved
     mode's synchronous drains; any other sync, or any sync or wait that
     leaves the card idle in a group with rescues in flight, fails); detect launches = frames, refine = frames
     - 1; the rescued edges' errors against ground truth; dark_stretch
     must rescue at least once with L1 below DARK_L1_MAX, and its rescued
     edges' median translation error must stay below RESCUE_ERR_MAX x
     their median true motion. Then default_params() with use_icp on a
     DEFAULT_ICP_FRAMES-frame dark stretch (the default path's inline
     batched rescue): fps, nodes,
     rescues, ATE, launches.

 12. the TUM entry point: the bench frames written as a TUM directory
     twice, in a temporary directory deleted at the end: by
     io/synthetic.save_as_tum_dataset (the port's PNG writer: every row Up,
     deflate level 1), and as libpng writes them (adaptive_png: adaptive
     filters, zlib's default level, 8 KiB IDAT chunks; TUM's own files).
     For each: every frame decodes back to its rendered bytes (RGB, depth
     u16) with decode ms a frame split into read, chunks + CRCs + inflate,
     C unfilter and image; the rows a filter type holds (the adaptive
     files must hold Paeth rows); the C unfilter against the numpy one
     (UNFILTER_FRAMES Up frames, UNFILTER_FRAMES_ADAPTIVE adaptive ones)
     and the numpy unfilter's ms; the TumLoader's frames/s. Then
     `rgbdslam-torch run --evaluate --save-clouds --save-octomap
     --save-g2o --save-features` on the adaptive directory with
     make_pipe's -p pairs, in process (apps.cli.main): L4 at most 0.03 m,
     detect launches = frames, refine = frames - 1, the trajectory equal to
     run_arrays' on the same frames (the meters TumDataset.load gives)
     within 1e-5 m (bench_config_run warms up one frame at a time and
     optimizes after it, which the CLI does not: run_arrays is the same
     path), every output parsed by the port's readers (g2o vertices =
     nodes, edges = active edges, features = valid keypoints, an octomap
     and a cloud with points), the ate subcommand within 1e-6 m of the
     report's L4 (the file rounds to 1e-7 m); the voxel map of VOXEL_NODES
     node clouds on the card equal to the CPU's; the default configuration
     through the CLI on TUM_DEFAULT_FRAMES frames (L4 at most
     DEFAULT_ATE_L4_MAX); a checkpoint after CHECKPOINT_AT frames loaded
     into a fresh pipeline, both fed CHECKPOINT_MORE more frames, once
     with no online optimize (poses and statistics equal) and once with it
     every 10 frames (poses within 1e-5 m: its float atomic adds on the
     card part the two in the last bits; at least one optimize must run
     after the load). Printed only: save ms, peak memory, the replayed
     groups' syncs and waits, and run_tum on each directory against
     run_arrays fps on TUM_FPS_FRAMES frames, alternating, with the loader's
     waits and each run's
     wall, main-thread CPU and process CPU ms a frame.

 13. the feature families on make_pipe (FAMILY_PARAMS), on the bench
     frames: SIFTGPU at the reference's published evaluation settings over
     SIFT_FRAMES frames: fps, ATE L0..L4 (L4 at most 1.5 x SIFT_L4_JAX, the
     JAX package's on the same frames), graph, launches (detect 0, refine
     frames - 1), 0 syncs in replayed groups, peak memory; the SIFT
     extractor's device ms and activities on one frame against its bound
     (sift_extractor_bound), and the whole step's a frame from a captured
     group replayed; 4 frames a step replayed against 1 eager on
     EQUAL_FRAMES frames (poses equal exactly: the histograms are
     fixed-order sums). BRISK and FREAK over FAMILY_FRAMES frames: L4 at
     most max(2 x, + 0.005 m) phase 6's ORB L4 (tests/test_slam_e2e.py's
     bound), detect launches = frames, refine = frames - 1. ORB with bf16
     and float32 descriptor stores, every step eager, DTYPE_FRAMES frames:
     poses and statistics equal to the int8 store's.
 14. the device step's remaining options (OPTIONS), each on make_pipe on
     the bench orbit with the native encoder, one run each as phase 6
     drives it: g2o_transformation_refinement=3, tpu_emm_exact,
     tpu_edge_info=hessian, the delta wire (yc12, 6/10 bits implied, 2
     frames a step) at the default clamp budget and at 0.3, 6- and 5-bit
     luma, the raw wire, a 644x484 render under ydct (logs the fallback and
     runs as yc12), and default_params() with the projective refinement
     and Hessian edges: fps, ATE L1 and L4 (L4 at most max(1.5 x, + 5 mm)
     the JAX package's mean over RANSAC seeds 0-3 on the same frames,
     held in OPTIONS), nodes, accepted
     edges, detect launches = frames, refine = frames - 1, 0 syncs and 0
     idle waits in replayed groups; under the delta wire the I and P wires
     and bytes a frame. Replayed groups against eager single steps on
     EQUAL_FRAMES frames (poses within 1e-6, equal statistics) with the
     delta wire (2 frames a step, P wires flowing) and with
     g2o_transformation_refinement=3 (4 frames a step).
 15. the bag and point-cloud inputs and batch evaluation, on the bench
     frames, at make_pipe: BAG_FRAMES (120) frames written as a ROS bag by
     the port's write_rgbd_bag (rgb8, u16 depth as 32FC1 meters, ground
     truth on /tf as /kinect, uncompressed chunks; its MiB, the seconds to
     pair it, the ms a frame to decode the arrays, which must equal the
     written frames); `rgbdslam-torch run --bagfile --evaluate --save-bag -p
     ground_truth_frame_name=/kinect` with make_pipe's -p pairs: finite
     ATE, the report's L0..L4 within 1e-6 m of the ATE against the
     rendered poses, detect launches = frames, refine = frames - 1, the
     trajectory files within 1e-5 m of run_arrays' on the same frames,
     result.bag read back (one tf a node, positions within 1e-6 m); run_bag
     against run_arrays fps, alternating. PCD_FRAMES (60) frames as
     organized binary PCDs (write_pcd, NaN rows for invalid depth): each
     loads back through CloudDataset with its depth bitwise and its
     colours equal (load ms a frame); `rgbdslam-torch run --pcd-dir
     --evaluate` within 1e-5 m of run_arrays, launches as above.
     evaluate_sequences on the card over phase 12's two TUM directories
     (EVAL_FRAMES frames, make_pipe and its one-frame-a-step yc12 variant):
     summary.csv with a header and 4 rows, every L4 finite. Then
     tpu_frames_per_step=3 (F22) on EQUAL_FRAMES frames fed in chunks
     (F22_CHUNKS) whose tails hold 2 frames: groups of 3 and of 2 each
     replayed, poses within 1e-6 of 1 frame a step eager, equal
     statistics, 0 syncs and 0 idle waits in replayed groups.
 16. loop retrieval, robot odometry, landmark BA, empirical covariances,
     the stereo input and the mesh output, at 640x480: make_pipe with
     global_loop_candidates=2 on the bench frames as phase 6 drives it
     (fps, graph, loop edges and the longest loop span, retrievals and the
     hits they added, launches, 0 syncs and 0 idle waits in replayed
     groups, peak memory, L4 at most 0.03 m); one retrieval on its final
     store and on stores filled to RETRIEVAL_STORES nodes: the chunked
     counts equal the capacity-wide plain version's, device ms (profiler)
     and event span, the peak memory it adds, its bound; landmark BA on the
     run's graph (landmarks, observations, chi2 must fall, wall s), the
     empirical covariances (ms; finite information with positive
     diagonals), save_graph_viz (one line an active edge); the same
     configuration with room for hits (RETRIEVAL_EQUAL) on EQUAL_FRAMES
     frames, 4 a step replayed against the same groups eager (poses
     equal exactly, hits taken); plain make_pipe against it with
     retrieval, fps in clean processes (tools/make_pipe_fps.py,
     RETRIEVAL_FPS_FRAMES frames, one run each); default_params() with
     retrieval on HOST_FRAMES frames (a frame synchronizes once in
     graph/manager.py and once more a retrieval in loop_closing.py, L4
     within max(1.5 x, + 5 mm) of HOST_RETRIEVAL_L4_JAX); default_params()
     with ground-truth odometry, odometry only (positions within 1e-3 m,
     one odometry edge a frame, no refine launch) and beside the visual
     edges (an odometry edge a node, L4 at most DEFAULT_ATE_L4_MAX);
     `rgbdslam-torch synthetic --stereo 0.075` over STEREO_FRAMES frames,
     the disparity of STEREO_CHECK_FRAMES pairs on the card equal to the
     CPU's on at least 99.9% of the pixels, the front end's device ms a
     frame against its bound, then `run --stereo-dir --evaluate
     --save-mesh` with make_pipe (L4 within max(1.5 x, + 5 mm) of
     STEREO_L4_JAX, detect = frames, refine = frames - 1, run_stereo fps)
     and mesh.ply parsed, its faces and colours equal to the CPU's mesh of
     the same state and its vertices within 1e-5 m.
 17. many sequences at once (parallel/): MULTI_S sequences of MULTI_FRAMES
     640x480 frames, each on its own world (render_multi), through
     MultiSequenceSlam with make_pipe's parameters (multi_params: its
     pose_relative_to set to "first" as the UNSUPPORTED contract sets it)
     and its 5-level protocol, optimized online every optimizer_skip_step
     lockstep frames as the slam-multi CLI does: every L4 at most
     MULTI_L4_MAX; detect S a
     lockstep frame, refine S a frame after the first, Kabsch 0; 0
     synchronizing calls in replayed lockstep frames (one key: one
     eager frame, one capture); host ms a replayed frame (whole call,
     graph replay, drains, online optimizes), capture s, graph-pool MiB,
     state and peak MiB a sequence. Sequences MULTI_SINGLE alone through
     MultiSequenceSlam with S = 1 and tpu_seed i on the same wires (F25:
     a sequence of S computes what one alone does): equal edge mirrors,
     edge types and keyframes, L0 and L4 within MULTI_SINGLE_TOL. Without
     online optimizes, MULTI_EQUAL_FRAMES frames: the replayed lockstep
     graph equals eager steps and a 2-shard mesh on the one card equals
     mesh=None, bitwise. sharded_compare over that mesh equals the
     per-shard calls bitwise; sharded_lm_iteration on a 1024-node loop
     graph is within the JAX test's tolerances of lm_iteration.
     vo_trajectories_sharded on the same sequences (VO_MULTI): L0 within
     max(1.5 x, + 5 mm) of VO_MULTI_L0_JAX, detect and refine launches.
     GraphManager with tpu_mesh_devices above the cards raises ValueError;
     `rgbdslam-torch slam-multi --devices auto` on phase 12's two TUM
     directories writes its report. In clean processes
     (tools/slam_multi_fps.py, tools/make_pipe_fps.py): sequence-frames/s
     against S x make_pipe's fps on sequence 0, and a torch.profiler
     window's device ms and busy share a lockstep frame.
 18. the live viewer and the run controls (ROADMAP item 27b): `rgbdslam-torch
     run --tum-dir --serve 0` with make_pipe's parameters on SERVE_FRAMES
     frames of phase 12's Up directory, in this process, driven over HTTP
     from a thread of its own at fixed frames (SERVE_SCRIPT; the run loop
     waits while each request lands): /ctl/save (cloud.pcd at the next
     refresh), /ctl/pause (the SERVE_DROPPED frames dropped: no detect or
     refine launch, no counter moves), /ctl/step (exactly one frame, one
     launch of each), /ctl/pause again (running), and
     /ctl/param?name=observability_threshold&value=1.0 at frame
     SERVE_PARAM_AT: one new CUDA-graph key (one eager group, one capture)
     with no synchronizing call in the replayed groups after it, and every
     later frame entering by its constant-position edge alone. The same
     run stepped eagerly (no CUDA graph) with the same controls: edge
     mirrors equal, poses within SERVE_POSE_TOL (the online optimizes'
     float atomics). The live outputs parse (estimate.txt, graph.g2o,
     cloud.pcd, frame.png, depth.png) and the page with the controls and
     the panes is served during the CLI's final linger; `view --html
     --views 2` writes two 960x720 PNGs and the page; `serve` in a
     process of its own answers GET /. run_tum's fps with the live view on
     (live_dir, a server up) and off, alternating after a warm-up run
     with it on (the first run of the loop has run up to 45% slower),
     SERVE_FRAMES frames each, with a refresh's ms split into the card reads on the run loop
     and the files' writing on the worker thread; utils/roofline.py's table of the step's stages (device ms from a
     torch.profiler trace against the bytes and float32 bounds).
Phase 2 also holds the refine kernel with its projective stage
(projective_iterations PROJ_ITERATIONS) to its plain version in float64.

Before the last line it prints one JSON object with the kernels' measured
numbers (launches from phase 6's run, the bench configuration, and from
each later phase's; the Kabsch kernel's are 0 there, its refits having
moved into the refine kernel; the refine kernel with its projective stage
has an entry of its own, launched on phase 14's refinement runs); the last
line is {"ok": true, "device": {...}}. --frames N (at least SERVE_FRAMES,
120: phase 18's control sequence) shortens phases 3-17 to N frames each.

bench_params() and render_bench() hold the cell's configuration and data.
A traced window of the benchmark's cells, kernel by kernel with the
program's spans beside the kernels, is `python3 slambench/run.py
--workload <cell> --seed <n> --seconds 20 --trace 1`.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
THRESHOLDS = (0.06, 0.015, 0.001875)  # FAST thresholds held bitwise
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# float operations a pixel of the plain version: Sobel 20 + products 3 +
# two 5-tap blurs of three maps 54 + Harris 7 + FAST 2 + 32 compares + NMS 9
DETECT_OPS_PER_PX = 127
# float operations of one weighted Kabsch fit: 41 a point (clamp, the
# weighted sums, centring and the 3x3 outer products) and ~1200 for the 3x3
# part (H^T H, about five Jacobi sweeps, the rotation)
KABSCH_OPS_PER_POINT = 41
KABSCH_OPS_PER_PROBLEM = 1200
# R entries and t (m), kernel against the plain version in float64 (in
# float32 the plain version's own rounding reaches ~1.1e-5 m in t at the
# test problems' 2-6 m centroids)
KABSCH_TOL = 1e-5
FP64_OPS_PER_S = 34e12  # H100 SXM float64 rate outside the tensor cores (data sheet)
# the RANSAC refine kernel: main-path refits and gate, kernel against the
# plain version in float64 (T within KABSCH_TOL, rmse relative)
REFINE_ITERATIONS = 4
MAX_MAHAL_SQ = 9.0
REFINE_RMSE_RTOL = 1e-5
NEAR_THRESHOLD = 1e-4  # x max_mahal_sq: a float64 m2 this close may gate either way
# float operations (double in the kernel) of the refine loop: a weighted
# match in one fit's moment pass (shift, the 16 weighted sums), a valid
# match in one gate (R s + t - d, Sigma, the adjugate solve, the quadratic
# form), and one fit's 3x3 part
REFINE_FIT_OPS_PER_MATCH = 40
REFINE_GATE_OPS_PER_MATCH = 120
EQUAL_FRAMES = 60  # frames of the grouped-equality phase
ATE_L4_MAX = 0.03  # metres
# The default configuration closes no loop (its 8 candidate slots go to 4
# predecessors and 4 geodesic neighbours, none to sampled keyframes), so it
# drifts: the JAX package itself reads L4 0.0562 m on this trajectory at
# 160x120 over 300 frames (tools/default_path_ate.py, on the CPU). Bound:
# that x 1.5.
DEFAULT_ATE_L4_MAX = 1.5 * 0.0562  # metres
WARMUP = 20  # frames before the timed run, as in bench.py
MAIN_FRAMES = 260  # frames of phases 3-4, keep-all one frame a step (520 until PR 7)
DEFAULT_FRAMES = 150  # frames of the default-configuration phase (300 until PR 7)
WORLD_SEED = 0  # synthetic world (textures, boxes)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    print(f"chip_smoke: {phase_seconds()}", file=sys.stderr, flush=True)
    sys.exit(1)


_PHASE_S: dict = {}  # first line of each phase -> seconds since the start


def phase_seconds() -> str:
    """Seconds from each phase's first line to the next phase's (to now for
    the last)."""
    marks = sorted(_PHASE_S.items(), key=lambda kv: kv[1]) + [("end", time.perf_counter())]
    return "seconds from each phase's first line to the next's: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:]))


def phase(msg: str) -> None:
    tag = msg.split("]")[0].lstrip("[") if msg.startswith("[") else None
    if tag and tag not in _PHASE_S:
        _PHASE_S[tag] = time.perf_counter()
    print(msg, flush=True)


def median_ms(fn, n: int = 20) -> float:
    import torch

    fn()  # warm
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int = 20):
    """Mean device ms of one call of fn (utils/roofline.device_ms: the
    device activities of a torch.profiler trace of n calls); None when no
    trace holds any."""
    from rgbdslam_v2_tpu_torch.utils.roofline import device_ms as traced

    return traced(fn, n)


def device_ops(fn) -> int:
    """Device activities (kernels, copies) one call of fn records in a
    torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type.name == "CUDA" for e in prof.events())


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


# bench.py's make_pipe configuration (bench.py:170-207, n_nodes=1024,
# n_edges=8192), parameter for parameter
MAKE_PIPE = dict(
    max_keypoints=600, tpu_max_nodes=1024, tpu_max_edges=8192, tpu_candidate_batch=8,
    ransac_iterations=200, optimizer_skip_step=10, keep_all_nodes=True,
    observability_threshold=0.5, pose_relative_to="inaffected", emm_skip_step=4,
    tpu_ingest_format="ydct", tpu_dct_quality="2.7", tpu_gray_bits=8, tpu_depth_bits=10,
    tpu_frames_per_step=4, tpu_encode_ahead=True,
)


# phase 13: the feature families on make_pipe. SIFTGPU at the reference's
# published evaluation settings (test/README: SIFTGPU, 600 features, 8
# candidates, RANSAC 100, ratio 0.9, RootSIFT; SURVEY.md section 6)
FAMILY_PARAMS = {
    "SIFTGPU": dict(feature_detector_type="SIFTGPU", feature_extractor_type="SIFTGPU",
                    ransac_iterations=100, nn_distance_ratio=0.9,
                    squareroot_descriptor_space=True),
    "BRISK": dict(feature_extractor_type="BRISK"),
    "FREAK": dict(feature_extractor_type="FREAK"),
}


# The JAX package's protocol L4 with FAMILY_PARAMS["SIFTGPU"] on make_pipe
# over the bench's first 520 frames rendered by the JAX package, on the CPU
# (tools/make_pipe_same_frames.py --frames 520 --seeds 0 --family SIFTGPU
# --packages jax). Phase 13 holds the port to 1.5 x it on its own renders of
# the same frames (the renderers agree within 1/255 and 1e-4 m).
# Both packages track this orbit far worse with SIFT than with ORB (the JAX
# package reads L0 0.4642, L4 0.1475 m, 957 sequential + 71 loop edges;
# ROADMAP F16).
SIFT_L4_JAX = 0.1475  # metres
SIFT_FRAMES = 520  # phase 13's SIFTGPU run
FAMILY_FRAMES = 260  # phase 13's BRISK and FREAK runs
DTYPE_FRAMES = 60  # phase 13's descriptor-store runs (bf16, float32 against int8)


# phase 2: the refine kernel's projective stage (g2o_transformation_refinement)
PROJ_ITERATIONS = 3
# double operations of the stage a weighted match a projective iteration
# (two uvz, two informations, three residuals and Jacobians, two
# transforms, the 3x3 normal equations and their solve, the 6-column
# Jacobian and its 27 pose terms) and of one 6x6 solve and exp_se3
PROJ_OPS_PER_MATCH = 620
PROJ_OPS_PER_SOLVE = 400
# phase 14: each option's frames, make_pipe overrides and the JAX package's
# protocol L4 (m) on the same JAX-rendered frames with RANSAC seeds 0-3, from
#   JAX_PLATFORMS=cpu python3 tools/make_pipe_same_frames.py --packages jax
#       --seeds 0 1 2 3 --frames N [--set NAME=VALUE ...] [--size WxH]
# on the CPU with the flags given beside each; the bound is
# max(1.5 x, + 5 mm) of their mean (option_limit). One seed alone is noisy
# (hessian reads 0.0220 and 0.0423 with seeds 0 and 1).
OPTIONS = {
    "g2o_refinement": (260, dict(g2o_transformation_refinement=3),
                       (0.0093, 0.0133, 0.0159, 0.0148), "--set g2o_transformation_refinement=3"),
    "emm_exact": (260, dict(tpu_emm_exact=True), (0.0214, 0.0232, 0.0214, 0.0203),
                  "--set tpu_emm_exact=true"),
    "hessian": (260, dict(tpu_edge_info="hessian"), (0.0220, 0.0423, 0.0328, 0.0312),
                "--set tpu_edge_info=hessian"),
    "delta": (260, dict(tpu_ingest_format="yc12", tpu_wire_delta=True),
              (0.0227, 0.0240, 0.0197, 0.0252),
              "--set tpu_ingest_format=yc12 --set tpu_wire_delta=true"),
    "delta_clamp_0.3": (120, dict(tpu_ingest_format="yc12", tpu_wire_delta=True,
                                  tpu_wire_delta_max_clamp=0.3),
                        (0.0679, 0.0622, 0.0530, 0.0710),
                        "--set tpu_ingest_format=yc12 --set tpu_wire_delta=true "
                        "--set tpu_wire_delta_max_clamp=0.3"),
    "gray6": (120, dict(tpu_ingest_format="yc12", tpu_gray_bits=6),
              (0.0258, 0.0229, 0.0177, 0.0222),
              "--set tpu_ingest_format=yc12 --set tpu_gray_bits=6"),
    "gray5": (120, dict(tpu_ingest_format="yc12", tpu_gray_bits=5),
              (0.0246, 0.0246, 0.0237, 0.0304),
              "--set tpu_ingest_format=yc12 --set tpu_gray_bits=5"),
    "raw": (120, dict(tpu_ingest_format="raw"), (0.0228, 0.0233, 0.0191, 0.0319),
            "--set tpu_ingest_format=raw"),
    "644x484": (60, {}, (0.0102, 0.0115, 0.0115, 0.0115), "--size 644x484"),
}
# default_params() with both refinements, on the host-decision path
OPTION_DEFAULT = (120, dict(g2o_transformation_refinement=3, tpu_edge_info="hessian"),
                  (0.0327, 0.0245, 0.0256, 0.0263), "--config default "
                  "--set g2o_transformation_refinement=3 --set tpu_edge_info=hessian")
CAM_644 = (525.0, 525.0, 321.5, 241.5, 644, 484)  # not divisible by 8, divisible by 4
# phase 14 runs each option once a RANSAC seed (tpu_seed) and holds the mean
# L4 to the bound: on an H100 hessian reads 0.0506, 0.0334, 0.0266 and
# 0.0343 m with seeds 0-3, one draw alone as noisy as the JAX package's
OPTION_SEEDS = (0, 1)


# phase 17: S sequences of full SLAM in lockstep (parallel/slam_multi.py),
# each on its own world: world MULTI_WORLD_SEED0 + s, orbit
# MULTI_ORBIT_SEED0 + s, 640x480, depth without noise quantized to 1/5000 m
MULTI_S = 8
MULTI_FRAMES = 120
MULTI_WORLD_SEED0 = 100
MULTI_ORBIT_SEED0 = 200
MULTI_EQUAL_FRAMES = 40  # replay = eager and mesh = no mesh, no online optimize
MULTI_SINGLE = (0, 7)  # sequences run alone (MultiSequenceSlam with S = 1)
MULTI_L4_MAX = 0.05  # metres, tests/test_slam_multi.py's bound
MULTI_SINGLE_TOL = 1e-4  # metres: L0 and L4 of sequence i against it alone (float atomics)
MULTI_PROFILE_FRAMES = 10  # lockstep frames under torch.profiler (tools/slam_multi_fps.py)
# vo-multi's settings (the JAX CLI's: ORB with max_keypoints, RANSAC with
# ransac_iterations and min_matches, make_pipe's values), and the JAX
# package's L0 of each sequence on its own renders of the same frames, on
# the CPU (JAX_PLATFORMS=cpu python3 tools/vo_multi_jax_reference.py)
VO_MULTI = dict(max_keypoints=600, n_hypotheses=200, min_inliers=20, sigma_depth=0.01,
                max_matches=128, ratio=0.9, seed=0)
VO_MULTI_L0_JAX = (0.00446, 0.00442, 0.05279, 0.00599, 0.12747, 0.00262, 0.00511,
                   0.00316)  # metres, one a sequence


def option_limit(l4_seeds) -> float:
    """max(1.5 x, + 5 mm) of the JAX package's mean L4 over its seeds."""
    l4 = [v for v in l4_seeds if v is not None]
    mean = sum(l4) / len(l4)
    return max(1.5 * mean, mean + 0.005)


def make_pipe_params(**over):
    """MAKE_PIPE as the port's ParameterServer; `over` changes only the
    equality phase's copy."""
    from rgbdslam_v2_tpu_torch.config import ParameterServer

    return ParameterServer({**MAKE_PIPE, **over})


def kabsch_problems(rng, B, N):
    """B rigid problems of N points (numpy-seeded): a random rotation and
    shift, 1 cm of noise, weights in [0, 1) with ~30% zeros."""
    import numpy as np

    src = rng.normal(0.0, 1.0, (B, N, 3)) + rng.normal(0.0, 2.0, (B, 1, 3))
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    dst = (src @ R.transpose(0, 2, 1) + rng.normal(0.0, 1.0, (B, 1, 3))
           + rng.normal(0.0, 0.01, (B, N, 3)))
    wts = rng.uniform(0.0, 1.0, (B, N)) * (rng.uniform(size=(B, N)) > 0.3)
    return [a.astype(np.float32) for a in (src, dst, wts)]


def refine_problems(rng, B, M):
    """B candidates of M matches as ransac_register hands them to the
    refinement (numpy-seeded): points 1-5 m deep in a 640x480 view, a
    random motion, noise from the depth model, 30% outliers moved up to
    0.5 m, 95% valid; the depth weights and point covariances of
    ransac_register; a start T 2 mrad and 3 mm off the motion and its
    isotropic-gate inliers, as the hypothesis sweep leaves them. Returns
    the (src, dst, w_depth, src_cov, dst_cov, valid, T, inliers) arrays."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core.noise import point_covariance_diag

    def rot(v):  # rotation vectors (B, 3) -> (B, 3, 3), Rodrigues
        th = np.linalg.norm(v, axis=1)[:, None, None]
        k = v / np.maximum(th[:, 0], 1e-12)
        K = np.zeros((len(v), 3, 3))
        K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
        K = K - K.transpose(0, 2, 1)
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K

    def cov(z):
        return point_covariance_diag(torch.from_numpy(z), 525.0, 525.0, 0.01).numpy()

    z = rng.uniform(1.0, 5.0, (B, M))
    src = np.stack([rng.uniform(-0.6, 0.6, (B, M)) * z, rng.uniform(-0.45, 0.45, (B, M)) * z,
                    z], -1)
    rv, tv = rng.normal(0.0, 0.05, (B, 3)), rng.normal(0.0, 0.1, (B, 3))
    dst = src @ rot(rv).transpose(0, 2, 1) + tv[:, None]
    dst += rng.normal(size=dst.shape) * np.sqrt(cov(z.astype(np.float32)))
    out = rng.uniform(size=(B, M)) < 0.3
    dst[out] += rng.uniform(-0.5, 0.5, (int(out.sum()), 3))
    valid = rng.uniform(size=(B, M)) < 0.95
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    w = np.where(valid, 1.0 / (np.maximum(src[..., 2], 1e-3) * np.maximum(dst[..., 2], 1e-3)),
                 0.0).astype(np.float32)
    src_cov, dst_cov = cov(src[..., 2]), cov(dst[..., 2])
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = rot(rv + rng.normal(0.0, 0.002, (B, 3)))
    T[:, :3, 3] = tv + rng.normal(0.0, 0.003, (B, 3))
    diff = src @ T[:, :3, :3].transpose(0, 2, 1) + T[:, None, :3, 3] - dst
    inl = valid & ((diff * diff).sum(-1) / (src_cov + dst_cov).mean(-1) < MAX_MAHAL_SQ)
    return src, dst, w, src_cov, dst_cov, valid, T, inl


@contextlib.contextmanager
def patched(module, name, value):
    """module.name = value inside the block (a measurement's probe)."""
    found = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, found)


def refine_against_plain(args, iterations=REFINE_ITERATIONS, thr=MAX_MAHAL_SQ,
                         projective=None) -> dict:
    """The refine kernel on the card tensors `args` (refine_problems' eight,
    on the card) against its plain version run in float64 on the same
    inputs, and against it in float32: the differences, the matches whose
    float64 m2 lies within NEAR_THRESHOLD x thr of thr in any gate, and
    whether every check of the kernel's precision holds. projective: a
    registration.Projective (the stage of g2o_transformation_refinement),
    None for none."""
    import torch
    from rgbdslam_v2_tpu_torch.ops import registration

    pj = projective or registration.NO_PROJECTIVE
    got = registration.ransac_refine(*args, iterations, thr, pj)
    gates = []
    exact = registration.mahalanobis_sq

    def recording(*a):  # every gate's float64 m2
        gates.append(exact(*a))
        return gates[-1]

    with patched(registration, "mahalanobis_sq", recording):
        ref = registration.ransac_refine_plain(
            *(a.double() if a.is_floating_point() else a for a in args), iterations, thr, pj)
    ref32 = registration.ransac_refine_plain(*args, iterations, thr, pj)
    torch.cuda.synchronize()
    valid = args[5]
    near = torch.zeros_like(valid)
    for m2 in gates:
        near |= valid & ((m2 - thr).abs() <= NEAR_THRESHOLD * thr)
    n_near = near.sum(-1)
    mask_bad = (got[1] != ref[1]) & ~near
    err_t = float((got[0] - ref[0]).abs().max())
    err_n = (got[2] - ref[2]).abs()
    r64 = ref[3]
    err_rmse = float(((got[3].double() - r64).abs() / r64.clamp(min=1e-30)).max())
    return dict(
        err_t=err_t, err_rmse=err_rmse, near=int(n_near.sum()),
        mask_diff=int((got[1] != ref[1]).sum()), err_t32=float((got[0] - ref32[0]).abs().max()),
        mask_diff32=int((got[1] != ref32[1]).sum()), n_diff32=int((got[2] - ref32[2]).abs().max()),
        ok=(err_t <= KABSCH_TOL and not bool(mask_bad.any()) and bool((err_n <= n_near).all())
            and err_rmse <= REFINE_RMSE_RTOL),
        got=got, ref=ref)


def sync_sites(fn) -> list:
    """Run fn with CUDA sync debugging on; "file:line" of each synchronizing
    call it made."""
    import torch

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in rec
            if "synchroniz" in str(w.message)]


def watch_groups(pipe) -> dict:
    """Wrap pipe._process_group so that each group call records (sites of
    its syncs, blocking drain copies, rescues in flight at its start, (waits
    for copies not landed, of them idle)) under "replay" when it only
    replayed a captured graph, else under "setup"; returns that dict.
    `del pipe._process_group` unwraps."""
    mgr = pipe.manager
    group, sg = pipe._process_group, mgr.step_graph
    syncs = {"replay": [], "setup": []}

    def watched_group(*a, **kw):
        before = (sg.captures, sg.eager_groups)
        pulls, pending = mgr.blocking_pulls, len(mgr._pending_rescues)
        waits = (mgr.copy_waits, mgr.idle_waits)
        sites = sync_sites(lambda: group(*a, **kw))
        syncs["replay" if (sg.captures, sg.eager_groups) == before else "setup"].append(
            (sites, mgr.blocking_pulls - pulls, pending,
             (mgr.copy_waits - waits[0], mgr.idle_waits - waits[1])))

    pipe._process_group = watched_group
    return syncs


def bench_config_run(poses, rgbs, depths, stamps, dev, keep=False, cam=None, params=None,
                     **over) -> dict:
    """Phase 6 (and phases 10 and 11 on their sequences):
    make_pipe_params(**over) on the sequence as bench.py drives it (20
    warm-up frames one at a time, a blocking optimize, the rest through
    run_arrays, then the protocol), with the kernels' launches and the host
    encodes by route counted from 0, and for each timed group its
    synchronizing calls, its blocking drain copies (starved mode), its
    waits for asynchronous copies that had not landed (copy_waits: staged
    drains, rescue verdicts) and whether retroactive rescues were in
    flight; the byte length of every wire (key "wire_lengths"). keep: also
    return the pipeline (key "pipe"). cam: the camera (TUM_DEFAULT);
    params: a ParameterServer in place of make_pipe_params(**over)."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.graph import ingest
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION
    from rgbdslam_v2_tpu_torch.ops import detect, registration
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    frames = len(rgbs)
    # earlier runs' pipelines are cyclic garbage until a collection frees
    # their device tensors (torch.cuda.graph collects before a capture):
    # collect first, so the peak is this run's
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    detect.reset_launches()
    alignment.reset_launches()
    registration.reset_launches()
    ingest.reset_encodes()
    pipe = SlamPipeline(cam or TUM_DEFAULT, params or make_pipe_params(**over), device=dev)
    mgr = pipe.manager
    wire_lengths = []
    encode = mgr.encode

    def recording_encode(*a):
        wire = encode(*a)
        wire_lengths.append(len(wire))
        return wire

    mgr.encode = recording_encode
    for i in range(WARMUP):  # as bench.py warms up: one frame at a time
        pipe.process_frame(rgbs[i], depths[i], float(stamps[i]),
                           gt_pose=poses[0] if i == 0 else None)
    mgr.optimize(blocking=True)
    sg = mgr.step_graph
    syncs = watch_groups(pipe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.params.set("skip_first_n_frames", WARMUP)
    pipe.run_arrays(rgbs, depths, stamps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del pipe._process_group
    del mgr.encode
    replay = syncs["replay"]
    out = dict(
        fps=(frames - WARMUP) / dt, ms_per_frame=1e3 * dt / (frames - WARMUP),
        detect_launches=detect.LAUNCHES, kabsch_launches=alignment.LAUNCHES,
        refine_launches=registration.LAUNCHES, encodes=dict(ingest.ENCODES),
        captures=sg.captures, eager_groups=sg.eager_groups, replays=sg.replays,
        replay_host_ms=1e3 * sg.replay_s / max(sg.replays, 1),
        replay_groups=len(replay), setup_groups=len(syncs["setup"]),
        replay_syncs=sum(len(x) for x, _, _, _ in replay),
        replay_sites=[x for g, _, _, _ in replay for x in g],
        setup_sites=[x for g, _, _, _ in syncs["setup"] for x in g],
        # replayed groups' syncs beyond their blocking drain copies (each
        # copy is one sync in graph/manager.py): must be 0
        replay_pulls=sum(p for _, p, _, _ in replay),
        unexplained_syncs=sum(max(len(x) - p, 0) + sum(site.split(":")[0] != "manager.py"
                                                       for site in x) for x, p, _, _ in replay),
        rescue_groups=sum(bool(r) and not p for _, p, r, _ in replay),
        rescue_group_syncs=sum(len(x) for x, p, r, _ in replay if r and not p),
        # waits for asynchronous copies that had not landed in replayed
        # groups, and those of them that left the card with no step queued
        # (idle: must be 0), also in the groups with rescues in flight
        replay_waits=sum(w for _, _, _, (w, _) in replay),
        replay_idle=sum(i for _, _, _, (_, i) in replay),
        rescue_group_waits=sum(w for _, p, r, (w, _) in replay if r and not p),
        rescue_group_idle=sum(i for _, p, r, (_, i) in replay if r and not p),
        copy_waits=mgr.copy_waits, idle_waits=mgr.idle_waits,
        stats=mgr.statistics(),
        const_edges=sum(t == EDGE_CONST_POSITION for t in mgr.host.edge_types),
        rescue_items=mgr.rescue_items,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        wire_lengths=wire_lengths, dropped=pipe.n_dropped,
    )
    t0 = time.perf_counter()
    for i in range(WARMUP):
        mgr.encode(rgbs[i], depths[i])
    out["encode_ms"] = 1e3 * (time.perf_counter() - t0) / WARMUP
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
    out["protocol_s"] = time.perf_counter() - t0
    est = mgr.poses()
    out["poses_ok"] = est.shape == (frames, 4, 4) and bool(np.isfinite(est).all())
    out["ate"] = [rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)]
    out["final_stats"] = rep.statistics
    if keep:
        out["pipe"] = pipe
    return out


def bench_params():
    """The keep-all VGA cell: bench.py's make_pipe with the ported slice's
    path selectors (yc12 ingest, one frame per step, no encode-ahead,
    pose_relative_to=first, synchronous drains)."""
    from rgbdslam_v2_tpu_torch.config import ParameterServer

    return ParameterServer(dict(
        max_keypoints=600, tpu_max_nodes=1024, tpu_max_edges=8192, tpu_candidate_batch=8,
        ransac_iterations=200, optimizer_skip_step=10, keep_all_nodes=True,
        observability_threshold=0.5, pose_relative_to="first", emm_skip_step=4,
        tpu_ingest_format="yc12", tpu_gray_bits=8, tpu_depth_bits=10,
        tpu_frames_per_step=1, tpu_encode_ahead=False, tpu_drain_pipelined=False,
    ))


def render_bench(world, frames: int, device):
    """The bench sequence rendered on device: (poses, rgb u8, depth u16 TUM
    counts, stamps) with depth noise 0.01 z^2 and 1/5000 m quantization."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.io import render_sequence

    poses, rgbs, depths = render_sequence(world, frames, seed=2,
                                          depth_noise_sigma=0.01, device=device)
    depths = np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    return poses, rgbs, depths, np.arange(frames) / 30.0


# tools/hard_sequences.py's stress worlds at full scale (its build_sequences
# with small=False), rendered by the port: world seed, render seed, world
# and render options
HARD = {
    "low_texture": (3, 4, dict(texture_contrast=(1.0, 0.04, 0.04, 0.04, 1.0, 1.0)), {}),
    "depth_holes": (5, 6, {}, dict(depth_dropout=14)),
    "dark_stretch": (7, 8, {}, {}),
}
HARD_FRAMES = 300  # tools/hard_sequences.py's n_tex at full scale
SPIN_FRAMES = 260  # bench.py:430
SPIN_L1_MAX = 0.15  # tests/test_hard_sequences.py:37 (160x120; no VGA bound exists)
# The dark stretch at 640x480 (60 dark frames of 300) against its JAX
# reference: tests/test_hard_sequences.py:39's 0.20 m holds at 160x120 over
# 48 frames, but on these frames the JAX package itself reads L1 0.3679 m
# (make_pipe + use_icp, tools/make_pipe_same_frames.py --sequence
# dark_stretch --icp --frames 300, on the CPU; the port 0.2804 m there).
# Bound: that x 1.25, the north star's ATE ratio to the reference.
DARK_L1_MAX = 1.25 * 0.3679  # metres
# The rescue's own check: on these frames a broken rescue would pass the
# L1 bound (on an H100, without use_icp or with the rescue's writes
# discarded, the port reads L1 0.1434 m against 0.2594-0.2618 with it,
# tools/bench_config_runs.py --sequence dark_stretch: at 640x480 the rescue
# costs accuracy, in the JAX package too, ROADMAP F12). So the rescued
# edges are held to ground truth: their median translation error must stay
# below this share of their median true motion, the error of the
# constant-position edge each replaces (a rescue that writes nothing reads
# 1.0; the port reads 0.47 on the same run).
RESCUE_ERR_MAX = 0.75
# the default path's dark stretch (its frames 24-36 dark; once 120 frames)
DEFAULT_ICP_FRAMES = 60
FR2_ROUNDS = 4  # bench.py:386


def render_hard(name: str, frames: int, device):
    """A hard sequence at 640x480 rendered on the card: (poses, rgb u8,
    depth u16 TUM counts, stamps, note), depth noise 0.01 z^2."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence
    from rgbdslam_v2_tpu_torch.io.synthetic import dark_stretch

    if name == "spin360":
        world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
        traj = world.spin_trajectory(frames, seed=2, deg_per_frame=3.0, device=device)
        poses, rgbs, depths = render_sequence(world, frames, seed=2, depth_noise_sigma=0.01,
                                              trajectory=traj.cpu().numpy(), device=device)
        note = "90 deg/s yaw spin"
    else:
        wseed, rseed, wopt, ropt = HARD[name]
        world = SyntheticWorld.create(seed=wseed, cam=TUM_DEFAULT, **wopt)
        poses, rgbs, depths = render_sequence(world, frames, seed=rseed, depth_noise_sigma=0.01,
                                              device=device, **ropt)
        note = {"low_texture": "3 walls at 4% contrast",
                "depth_holes": f"{ropt.get('depth_dropout')} depth holes a frame"}.get(name, "")
        if name == "dark_stretch":
            rgbs, lo, hi = dark_stretch(rgbs)
            note = f"frames {lo}-{hi} at ~3% contrast"
    depths = np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)
    return poses, rgbs, depths, np.arange(frames) / 30.0, note


def ms_quartiles(times_s) -> str:
    import numpy as np

    q1, q2, q3 = np.percentile(1e3 * np.asarray(times_s), [25, 50, 75])
    return f"median {q2:.3f} ms (IQR {q1:.3f}-{q3:.3f})"


def encode_check(rgbs, depths, dev) -> dict:
    """Phase 8: the native encoder against the numpy encoder on every
    frame (host only, make_pipe's stride 2 and 10-bit depth): yc12 bytes
    equal, ydct codes within 1 and their share of differing codes, the
    device decode of the native wire against the numpy decode of it, and
    both decodes against each other; encode times by route."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.graph import ingest
    from rgbdslam_v2_tpu_torch.ops import dct_wire

    sp = dct_wire.spec(MAKE_PIPE["tpu_dct_quality"])
    H, W = depths.shape[1:]
    nl = dct_wire.dct_luma_len(H, W, sp)
    times = {k: [] for k in ("yc12 native", "yc12 numpy", "ydct native", "ydct numpy")}
    out = dict(yc12_equal=0, code_diff=0, code_max=0, codes=0, dec_dev=0, dec_enc=0,
               dec_cross=0, dec_unexplained=0)
    ingest.reset_encodes()
    for rgb, depth in zip(rgbs, depths):
        wires = {}
        for key, fn, dct in (("yc12 native", ingest.compact_frame, None),
                             ("yc12 numpy", ingest.compact_frame_numpy, None),
                             ("ydct native", ingest.compact_frame, sp),
                             ("ydct numpy", ingest.compact_frame_numpy, sp)):
            t0 = time.perf_counter()
            wires[key] = fn(rgb, depth, 2, MAKE_PIPE["tpu_depth_bits"], dct)
            times[key].append(time.perf_counter() - t0)
        out["yc12_equal"] += bool(np.array_equal(wires["yc12 native"], wires["yc12 numpy"]))
        native, ref = wires["ydct native"][:nl], wires["ydct numpy"][:nl]
        cn, cr = dct_wire.luma_codes_np(native, H, W, sp), dct_wire.luma_codes_np(ref, H, W, sp)
        out["code_diff"] += int((cn != cr).sum())
        out["codes"] += cn.size
        out["code_max"] = max(out["code_max"], int(np.abs(cn - cr).max()))
        dn = dct_wire.decode_luma_dct_np(native, H, W, sp).astype(np.int16)
        dr = dct_wire.decode_luma_dct_np(ref, H, W, sp).astype(np.int16)
        dd = dct_wire.decode_luma_dct_dev(torch.from_numpy(native).to(dev), H, W, sp)
        dd = dd.cpu().numpy().astype(np.int16)
        out["dec_dev"] = max(out["dec_dev"], int(np.abs(dd - dn).max()))
        out["dec_enc"] = max(out["dec_enc"], int(np.abs(dn - dr).max()))
        # the decodes may differ only as far as the differing codes move the
        # pixels (the decoder is linear in the codes), within 1 for rounding
        bound = np.abs(dct_wire.code_delta_np(cn, cr, H, W, sp)) + 1.0
        out["dec_unexplained"] += int((np.abs(dn - dr) > bound).sum())
        out["dec_cross"] = max(out["dec_cross"], int(np.abs(dd - dr).max()))
    out["times"] = {k: ms_quartiles(v) for k, v in times.items()}
    out["median_ms"] = {k: 1e3 * statistics.median(v) for k, v in times.items()}
    out["encodes"] = dict(ingest.ENCODES)
    return out


def fr2_run(rgbs, depths, dev, rounds: int = FR2_ROUNDS) -> dict:
    """Phase 9: bench.py's fr2-scale phase (bench.py:361-415) on the port:
    make_pipe(4096, 65536) over the bench frames `rounds` times (the
    timestamps run on), 20 warm-up frames one at a time, each round's
    frames through run_arrays (4 frames a step as CUDA graph replays;
    bench.py feeds process_frame, one frame a step), fps per round with
    the node count, then the final blocking optimize with
    pose_relative_to=first."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.ops import detect, registration
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    n = len(rgbs)
    torch.cuda.reset_peak_memory_stats()
    detect.reset_launches()
    alignment.reset_launches()
    registration.reset_launches()
    pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(tpu_max_nodes=4096, tpu_max_edges=65536),
                        device=dev)
    mgr = pipe.manager
    for i in range(WARMUP):
        pipe.process_frame(rgbs[i], depths[i], i / 30.0)
    torch.cuda.synchronize()
    sg = mgr.step_graph
    syncs = watch_groups(pipe)
    chunks = []
    for r in range(rounds):
        start = WARMUP if r == 0 else 0
        pipe.params.set("skip_first_n_frames", start)
        t0 = time.perf_counter()
        pipe.run_arrays(rgbs, depths, (r * n + np.arange(n)) / 30.0)
        torch.cuda.synchronize()
        chunks.append((mgr.n_nodes, (n - start) / (time.perf_counter() - t0)))
    del pipe._process_group
    replay = syncs["replay"]
    launches = (detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES)
    pipe.params.set("pose_relative_to", "first")
    solvers = dict(mgr.solver_calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chi2 = mgr.optimize(blocking=True)
    opt_ms = 1e3 * (time.perf_counter() - t0)
    solver = [k for k in solvers if mgr.solver_calls[k] > solvers[k]]
    stats = mgr.statistics()
    est = mgr.poses()
    return dict(chunks=chunks, opt_ms=opt_ms, chi2=chi2, iters=mgr.last_optimize_iters,
                solver=solver, stats=stats, launches=launches, captures=sg.captures,
                replays=sg.replays, replay_syncs=[x for g, *_ in replay for x in g],
                replay_waits=sum(w for *_, (w, _) in replay),
                replay_idle=sum(i for *_, (_, i) in replay),
                poses_ok=bool(np.isfinite(est).all()), frames=n * rounds,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def rescue_edge_errors(mgr, poses) -> dict:
    """The accepted retroactive rescues against ground truth: each frame
    k's fallback edge (k - 1 -> k, the last of its B + 1 reserved slots)
    that a rescue retyped sequential, its measurement's translation (m)
    and rotation (deg) error against the true relative pose, beside the
    true motion (the error of the constant-position edge it replaced).
    Median and max of each over the rescued edges, and the length of the
    summed translation errors (what a chain of them drifts)."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_SEQUENTIAL

    B1 = mgr.cand_batch + 1
    h = mgr.host
    slots = [k * B1 - 1 for k in range(1, mgr.n_nodes)
             if h.edge_types[k * B1 - 1] == EDGE_SEQUENTIAL
             and (h.edge_i[k * B1 - 1], h.edge_j[k * B1 - 1]) == (k - 1, k)]
    if not slots:
        return dict(n=0)
    meas = mgr.graph.edge_meas[slots].double().cpu().numpy()
    P = np.asarray(poses, np.float64)
    gt = np.stack([np.linalg.inv(P[k - 1]) @ P[k] for k in (s // B1 + 1 for s in slots)])
    d = np.linalg.inv(gt) @ meas
    t_err = np.linalg.norm(d[:, :3, 3], axis=1)
    r_err = np.degrees(np.arccos(np.clip((np.trace(d[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                                         -1.0, 1.0)))
    motion = np.linalg.norm(gt[:, :3, 3], axis=1)
    med = lambda x: float(np.median(x))  # noqa: E731
    return dict(n=len(slots), t_med=med(t_err), t_max=float(t_err.max()), r_med=med(r_err),
                r_max=float(r_err.max()), motion_med=med(motion),
                t_sum=float(np.linalg.norm(d[:, :3, 3].sum(0))))


def fmt_rescue_errors(e: dict) -> str:
    if not e["n"]:
        return "no rescued edge"
    return (f"{e['n']} rescued edges against ground truth: translation error median "
            f"{e['t_med']:.4f} m (max {e['t_max']:.4f}), rotation median {e['r_med']:.3f} deg "
            f"(max {e['r_max']:.3f}); summed translation error {e['t_sum']:.4f} m; true "
            f"motion median {e['motion_med']:.4f} m (the constant-position edge's error)")


def rescue_item_ms(mgr, nid: int) -> dict:
    """Device time of one retroactive rescue item (node nid against its
    predecessor, as a drain would send it; on a copy of the graph) and of
    one ICP nearest-neighbour search at that item's shapes (distance matrix
    and first-index row minimum), from torch.profiler traces."""
    import dataclasses

    import torch
    from rgbdslam_v2_tpu_torch.core.camera import backproject_grid
    from rgbdslam_v2_tpu_torch.graph import rescue
    from rgbdslam_v2_tpu_torch.ops import icp

    p = mgr.params
    cam = mgr.cam_small
    graph = dataclasses.replace(mgr.graph, **{f.name: getattr(mgr.graph, f.name).clone()
                                              for f in dataclasses.fields(mgr.graph)})
    iters = int(p["icp_max_iterations"])

    def item():
        prev = (graph.poses[0], torch.zeros((), dtype=torch.bool, device=graph.poses.device), 0)
        return rescue.retro_rescue(graph, mgr.store.depth, mgr.store.emm_lohi, [nid],
                                   [0], prev, cam, iters, int(p["emm_skip_step"]),
                                   float(p["sigma_depth"]), str(p["icp_variant"]),
                                   float(p["observability_threshold"]))

    h, w = cam.height, cam.width
    new = backproject_grid(mgr.store.depth[nid].view(1, h, w), cam)
    dst = backproject_grid(mgr.store.depth[nid - 1].view(1, h, w), cam)
    dvalid = mgr.store.depth[nid - 1].view(1, h, w) > 0
    src = new[:, ::4, ::4].reshape(1, -1, 3)
    dst, dv = dst[:, ::2, ::2].reshape(1, -1, 3), dvalid[:, ::2, ::2].reshape(1, -1)
    dst_masked = torch.where(dv[..., None], dst, 1e6)
    d2_dst = (dst_masked * dst_masked).sum(-1)
    return dict(item_ms=device_ms(item, n=3),
                nearest_ms=device_ms(lambda: icp._nearest(src, dst_masked, d2_dst), n=10),
                iterations=iters, shape=(src.shape[1], dst.shape[1]))


# phase 12: frames before the save (at 260 the compressed save of their
# 83.5 MiB took ~16 s), after it
CHECKPOINT_AT, CHECKPOINT_MORE = 100, 60
TUM_FPS_FRAMES = 130  # phase 12: frames of each alternating fps run (once 520, then 260)
# phase 12: the default configuration's CLI run (phase 5 runs DEFAULT_FRAMES)
TUM_DEFAULT_FRAMES = 100
VOXEL_NODES = 10  # phase 12: node clouds inserted on the card and on the CPU
UNFILTER_FRAMES = 20  # phase 12: Up-filtered frames unfiltered in C and in numpy
# phase 12: adaptively filtered frames unfiltered in numpy too (its Average
# and Paeth rows are Python loops, ~1 s a frame)
UNFILTER_FRAMES_ADAPTIVE = 2
IDAT_BYTES = 8192  # libpng's IDAT chunk size


def adaptive_png(img) -> bytes:
    """img as libpng writes it by default: each row's filter the one of the
    five whose filtered bytes, read as signed, have the least absolute sum
    (libpng's heuristic), deflated at zlib's default level, in IDAT chunks
    of IDAT_BYTES. TUM's own PNGs come from libpng (through OpenCV)."""
    import zlib

    import numpy as np
    from rgbdslam_v2_tpu_torch.io import png

    if img.ndim == 3:
        ctype, depth, bpp, raw = 2, 8, 3, img.reshape(img.shape[0], -1)
    else:
        ctype, depth, bpp = 0, 16, 2
        raw = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    rows = raw.shape[0]
    cost = np.stack([
        np.abs(np.frombuffer(png.filter_rows(raw, bpp, t), np.int8).reshape(rows, -1)[:, 1:]
               .astype(np.int32)).sum(1) for t in range(5)])
    body = zlib.compress(png.filter_rows(raw, bpp, cost.argmin(0)), zlib.Z_DEFAULT_COMPRESSION)
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, ctype, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + b"".join(png._chunk(b"IDAT", body[k : k + IDAT_BYTES])
                       for k in range(0, len(body), IDAT_BYTES))
            + png._chunk(b"IEND", b""))


def decode_split(ds, n: int, rgbs, depths) -> dict:
    """Each of the n pairs of ds decoded on this thread as decode_png does it,
    timed by step (read the file, walk the chunks + CRCs + inflate, the C
    unfilter, the bytes as an image), checked against the rendered frame.
    Returns ms a frame by step, the frames that decode unequal and the
    filter types the rows use (a count for each)."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.io import png

    t = dict(read=0.0, inflate=0.0, unfilter=0.0, image=0.0)
    bad, types = [], np.zeros(5, np.int64)
    for i in range(n):
        got = []
        for f in (ds.pairs[i][1], ds.pairs[i][3]):
            t0 = time.perf_counter()
            data = (ds.root / f).read_bytes()
            t1 = time.perf_counter()
            inf = png.inflate_png(data)
            t2 = time.perf_counter()
            raw = png.unfilter_native(inf.filtered, inf.height, inf.row_bytes, inf.bpp)
            t3 = time.perf_counter()
            got.append(inf.image(raw))
            t4 = time.perf_counter()
            for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                t[k] += dt
            types += np.bincount(np.frombuffer(inf.filtered, np.uint8)[:: inf.row_bytes + 1],
                                 minlength=5)[:5]
        if not (np.array_equal(got[0], rgbs[i]) and np.array_equal(got[1], depths[i])):
            bad.append(i)
    out = {k: 1e3 * v / n for k, v in t.items()}
    out["total"] = sum(out.values())
    return dict(ms=out, bad=bad, filters=types.tolist())


def unfilter_check(ds, m: int) -> float:
    """The C unfilter against its numpy plain version on the first m pairs
    of ds (fails where they differ); the numpy unfilter's ms a frame."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.io import png

    t_np = 0.0
    for i in range(m):
        for f in (ds.pairs[i][1], ds.pairs[i][3]):
            inf = png.inflate_png((ds.root / f).read_bytes())
            t0 = time.perf_counter()
            plain = png.unfilter_numpy(inf.filtered, inf.height, inf.row_bytes, inf.bpp)
            t_np += time.perf_counter() - t0
            if not np.array_equal(
                    plain, png.unfilter_native(inf.filtered, inf.height, inf.row_bytes, inf.bpp)):
                fail(f"the C unfilter differs from numpy on {f}")
    return 1e3 * t_np / m


def make_pipe_flags() -> list:
    """MAKE_PIPE as the CLI's -p pairs."""
    return [x for k, v in MAKE_PIPE.items() for x in ("-p", f"{k}={v}")]


def run_cli(argv) -> tuple:
    """rgbdslam_v2_tpu_torch.apps.cli.main(argv) in this process, its output
    captured: (exit code, stdout, the SlamPipeline it built or None), its
    stderr printed to ours where the code is not 0 (an exception other than
    the CLI's own errors propagates with its traceback); the
    pipeline's save_clouds, save_octomap, save_mesh and run_stereo are timed
    (host clock, synchronized; key "save_ms" on the pipeline)."""
    import io

    import torch
    import rgbdslam_v2_tpu_torch.pipeline as pipeline_pkg
    from rgbdslam_v2_tpu_torch.apps import cli

    built = []

    class Recorded(pipeline_pkg.SlamPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.save_ms, self.group_syncs = {}, watch_groups(self)
            built.append(self)

        def _timed(self, name, fn, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.save_ms[name] = 1e3 * (time.perf_counter() - t0)
            return out

        def save_clouds(self, *a, **kw):
            return self._timed("save_clouds", super().save_clouds, *a, **kw)

        def save_octomap(self, *a, **kw):
            return self._timed("save_octomap", super().save_octomap, *a, **kw)

        def run_stereo(self, *a, **kw):
            return self._timed("run_stereo", super().run_stereo, *a, **kw)

        def save_mesh(self, *a, **kw):
            return self._timed("save_mesh", super().save_mesh, *a, **kw)

    buf, err = io.StringIO(), io.StringIO()
    with (patched(pipeline_pkg, "SlamPipeline", Recorded), contextlib.redirect_stdout(buf),
          contextlib.redirect_stderr(err)):
        code = cli.main([str(a) for a in argv])
    if code != 0:
        print(err.getvalue()[-4000:], file=sys.stderr, end="")
    return code, buf.getvalue(), built[0] if built else None


def against_arrays(res: Path, ref: Path) -> list:
    """Max difference of the trajectory files in res from those in ref by
    level (L0..L4, rows stamp + pose)."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.io.tum import read_trajectory_file

    return [float(np.abs(read_trajectory_file(res / f"estimate_iteration_{lvl}.txt")
                         - read_trajectory_file(ref / f"estimate_iteration_{lvl}.txt")).max())
            for lvl in range(5)]


def tum_phase(poses, rgbs, depths, dev, n_default: int, root: Path) -> dict:
    """Phase 12: the frames as a TUM directory through the port's own PNG
    codec, loader, run_tum and CLI (see the module docstring), in root, where
    its two TUM directories stay for phase 15. Every check that fails calls
    fail(); returns the numbers to print."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.graph.g2o_io import read_g2o
    from rgbdslam_v2_tpu_torch.io import TumDataset, TumLoader, save_as_tum_dataset
    from rgbdslam_v2_tpu_torch.io.png import FILTER_PAETH
    from rgbdslam_v2_tpu_torch.io.pointcloud import read_pcd
    from rgbdslam_v2_tpu_torch.io.tum import LOADER_THREADS
    from rgbdslam_v2_tpu_torch.mapping import VoxelMap
    from rgbdslam_v2_tpu_torch.mapping.octree_io import read_color_octree
    from rgbdslam_v2_tpu_torch.ops import detect, registration
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    n = len(rgbs)
    out = {}
    # what TumDataset.load gives for these frames: the u16 counts as meters
    meters = depths.astype(np.float32) / np.float32(5000.0)
    # the port's writer (every row Up, deflate level 1), then the same
    # frames as libpng writes them (adaptive filters, level 6)
    tum, tum_a = root / "tum", root / "tum_adaptive"
    t0 = time.perf_counter()
    save_as_tum_dataset(tum, poses, rgbs, depths)
    out["write_ms"] = 1e3 * (time.perf_counter() - t0) / n
    shutil.copytree(tum, tum_a)
    ds, ds_a = TumDataset.open(tum), TumDataset.open(tum_a)

    def write_adaptive(i):
        for k, img in ((1, rgbs[i]), (3, depths[i])):
            (tum_a / ds_a.pairs[i][k]).write_bytes(adaptive_png(img))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write_adaptive, range(n)))
    out["write_adaptive_ms"] = 1e3 * (time.perf_counter() - t0) / n
    stamps = ds.timestamps()
    out["png_mb"], out["decode"], out["loader_fps"] = {}, {}, {}
    for name, d in (("up", ds), ("adaptive", ds_a)):
        out["png_mb"][name] = sum(f.stat().st_size for f in d.root.rglob("*.png")) / 2**20
        # every frame decodes to its rendered bytes (C unfilter, one thread)
        dec = out["decode"][name] = decode_split(d, n, rgbs, depths)
        if dec["bad"] or len(d) != n:
            fail(f"TUM round trip ({name} filters): {len(dec['bad'])} of {n} frames decode "
                 f"unequal ({dec['bad'][:5]}), {len(d)} pairs")
        dec["numpy_unfilter_ms"] = unfilter_check(
            d, min(UNFILTER_FRAMES if name == "up" else UNFILTER_FRAMES_ADAPTIVE, n))
        t0 = time.perf_counter()
        with TumLoader(d) as loader:
            k = sum(1 for _ in loader)
        out["loader_fps"][name] = k / (time.perf_counter() - t0)
    if out["decode"]["adaptive"]["filters"][FILTER_PAETH] == 0:
        fail(f"adaptive PNGs hold no Paeth rows: {out['decode']['adaptive']['filters']}")
    out["loader_threads"] = LOADER_THREADS
    ds, tum = ds_a, tum_a  # the CLI reads what libpng writes

    # the CLI, in process: bench.py's make_pipe, the verify recipe's outputs
    res = root / "out"
    detect.reset_launches()
    alignment.reset_launches()
    registration.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    code, text, pipe = run_cli(["run", "--tum-dir", tum, "--out", res, "--evaluate",
                                "--save-clouds", "--save-octomap", "--save-g2o",
                                "--save-features", *make_pipe_flags()])
    out["cli_s"] = time.perf_counter() - t0
    out["launches"] = (detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if code != 0 or pipe is None:
        fail(f"rgbdslam-torch run exited {code}: {text[-2000:]}")
    mgr = pipe.manager
    report = json.loads((res / "estimate_report.json").read_text())
    out["ate"] = [report["ate_rmse"].get(str(lvl), float("nan")) for lvl in range(5)]
    out["stats"] = st = report["statistics"]
    out["save_ms"] = pipe.save_ms
    replay = pipe.group_syncs["replay"]
    out["replay_groups"] = len(replay)
    out["replay_syncs"] = sum(len(x) for x, *_ in replay)
    out["replay_idle"] = sum(i for *_, (_, i) in replay)
    out["replay_waits"] = sum(w for *_, (w, _) in replay)
    if out["launches"][0] != n or out["launches"][1] != n - 1:
        fail(f"TUM entry: detect launched {out['launches'][0]}, refine "
             f"{out['launches'][1]} times for {n} frames")
    if not all(np.isfinite(out["ate"])) or out["ate"][4] > ATE_L4_MAX:
        fail(f"TUM entry ATE {out['ate']}: not finite or L4 above {ATE_L4_MAX} m")
    # the same frames through run_arrays, the same configuration
    ref = SlamPipeline(TUM_DEFAULT, make_pipe_params(), device=dev)
    ref.run_arrays(rgbs, meters, stamps)
    ref.evaluation_protocol(root / "ref", gt_stamps=list(ds.groundtruth[:, 0]),
                            gt_xyz=ds.groundtruth[:, 1:4])
    # per level: the optimizer's float index_add_ are atomic adds on the
    # card, so two runs of one optimize may differ in the last bits
    out["traj_diff"] = against_arrays(res, root / "ref")
    out["pose_diff"] = float(np.abs(mgr.poses() - ref.manager.poses()).max())
    if max(out["traj_diff"]) > 1e-5 or out["pose_diff"] > 1e-5:
        fail(f"TUM entry against run_arrays: trajectory files differ by "
             f"{out['traj_diff']}, poses by {out['pose_diff']:.3e} (limit 1e-5)")
    # every output parses with the port's readers
    pts, cols = read_pcd(res / "cloud.pcd")
    centers, _, _, _ = read_color_octree(res / "map.ot")
    g_poses, g_fixed, g_edges = read_g2o(res / "graph.g2o")
    with np.load(res / "features.npz") as f:
        n_feat = int(f["positions"].shape[0])
    n_valid = int(mgr.store.kp_valid[: mgr.n_nodes].sum())
    out["outputs"] = dict(cloud_points=len(pts), occupied=len(centers),
                          vertices=len(g_poses), g2o_edges=len(g_edges), features=n_feat,
                          valid_keypoints=n_valid)
    if (len(g_poses) != mgr.n_nodes or len(g_edges) != st["active_edges"]
            or n_feat != n_valid or not len(centers) or not len(pts)
            or not np.isfinite(pts).all()):
        fail(f"TUM entry outputs: {out['outputs']}, nodes {mgr.n_nodes}, active edges "
             f"{st['active_edges']}")
    code, text, _ = run_cli(["ate", res / "estimate_iteration_4.txt", tum / "groundtruth.txt"])
    out["ate_cli"] = json.loads(text)["rmse"] if code == 0 else float("nan")
    # the file holds positions to 1e-7 m: a few 1e-8 m apart
    if not abs(out["ate_cli"] - out["ate"][4]) <= 1e-6:
        fail(f"ate subcommand {out['ate_cli']} against the report's L4 {out['ate'][4]}")

    # the voxel map: node clouds on the card and on the CPU
    maps = {"cuda": VoxelMap(pipe.map_config(), device=dev),
            "cpu": VoxelMap(pipe.map_config(), device="cpu")}
    ms = []
    for nid in np.linspace(0, mgr.n_nodes - 1, VOXEL_NODES).astype(int):
        cloud = [t.cpu() for t in pipe._node_world_cloud(int(nid))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps["cuda"].insert_cloud(*cloud)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        maps["cpu"].insert_cloud(*cloud)
    out["voxel_insert_ms"] = statistics.median(ms)
    out["voxel_differ"] = {
        k: int((getattr(maps["cuda"], k).cpu() != getattr(maps["cpu"], k))
               .reshape(-1, 3 if k == "rgb_sum" else 1).any(-1).sum())
        for k in ("logodds", "rgb_sum", "hits")}
    out["voxels_hit"] = int((maps["cpu"].hits > 0).sum())
    if any(out["voxel_differ"].values()):
        fail(f"voxel map: card and CPU differ in {out['voxel_differ']} voxels")
    del maps, pipe, mgr, ref

    # the default configuration through the CLI
    detect.reset_launches()
    registration.reset_launches()
    alignment.reset_launches()
    t0 = time.perf_counter()
    code, text, dpipe = run_cli(["run", "--tum-dir", tum, "--out", root / "default",
                                 "--evaluate", "--max-frames", min(n_default, TUM_DEFAULT_FRAMES)])
    out["default_s"] = time.perf_counter() - t0
    out["default_launches"] = (detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES)
    if code != 0:
        fail(f"rgbdslam-torch run (default configuration) exited {code}: {text[-2000:]}")
    rep = json.loads((root / "default" / "estimate_report.json").read_text())
    out["default_ate"] = [rep["ate_rmse"].get(str(lvl), float("nan")) for lvl in range(5)]
    out["default_stats"] = rep["statistics"]
    out["default_fps"] = rep["fps"]
    del dpipe
    if not all(np.isfinite(out["default_ate"])) or out["default_ate"][4] > DEFAULT_ATE_L4_MAX:
        fail(f"default configuration through the CLI: ATE {out['default_ate']} (L4 limit "
             f"{DEFAULT_ATE_L4_MAX})")

    # the checkpoint: save, load into a fresh pipeline, both go on.
    # Without the online optimize the poses must be equal; with it (every
    # optimizer_skip_step frames, the cadence restored from the file) its
    # atomic adds on the card let the two differ in the last bits
    out["checkpoint"] = {}
    if n >= CHECKPOINT_AT + CHECKPOINT_MORE:
        for name, limit, over in (
                ("no_optimize", 0.0,
                 dict(optimizer_skip_step=10 * (CHECKPOINT_AT + CHECKPOINT_MORE))),
                ("optimize", 1e-5, {})):
            a = SlamPipeline(TUM_DEFAULT, make_pipe_params(**over), device=dev)
            sl = slice(0, CHECKPOINT_AT)
            a.run_arrays(rgbs[sl], depths[sl], stamps[sl])
            t0 = time.perf_counter()
            a.manager.save_state(root / "state.npz")
            save_s = time.perf_counter() - t0
            mb = (root / "state.npz").stat().st_size / 2**20
            b = SlamPipeline(TUM_DEFAULT, make_pipe_params(**over), device=dev)
            t0 = time.perf_counter()
            b.manager.load_state(root / "state.npz")
            load_s = time.perf_counter() - t0
            optimizes, optimize = [], b.manager.optimize
            b.manager.optimize = lambda *x, **kw: optimizes.append(1) or optimize(*x, **kw)
            sl = slice(CHECKPOINT_AT, CHECKPOINT_AT + CHECKPOINT_MORE)
            for pipe in (a, b):
                pipe.run_arrays(rgbs[sl], depths[sl], stamps[sl])
            diff = float(np.abs(a.manager.poses() - b.manager.poses()).max())
            same = a.manager.statistics() == b.manager.statistics()
            ck = out["checkpoint"][name] = dict(
                save_s=save_s, load_s=load_s, mb=mb, diff=diff, same_stats=same,
                limit=limit, optimizes=len(optimizes),
                nodes=(a.manager.n_nodes, b.manager.n_nodes))
            del a, b
            if (not diff <= limit or (limit == 0.0 and not same) or len(set(ck["nodes"])) != 1
                    or (ck["optimizes"] > 0) != (name == "optimize")):
                fail(f"checkpoint continuation ({name}): poses differ by {diff:.3e} "
                     f"(limit {limit}), statistics equal {same}, nodes {ck['nodes']}, "
                     f"online optimizes after the load {ck['optimizes']}")

    # fps: the TUM entry (both directories) against run_arrays on the
    # same frames, alternating; per run the wall, the main thread's CPU
    # and the whole process's CPU ms a frame (every thread: loader,
    # encode-ahead, torch's)
    fps = {"tum_up": [], "tum_adaptive": [], "arrays": []}
    out["host"] = {k: [] for k in fps}
    out["loader_waits"] = {"tum_up": [], "tum_adaptive": []}
    n_fps = out["fps_frames"] = min(n, TUM_FPS_FRAMES)
    for kind in ("tum_up", "tum_adaptive", "arrays") * 2:
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(), device=dev)
        torch.cuda.synchronize()
        t0, c0, p0 = time.perf_counter(), time.thread_time(), time.process_time()
        if kind == "arrays":
            pipe.run_arrays(rgbs[:n_fps], meters[:n_fps], stamps[:n_fps])
        else:
            out["loader_waits"][kind].append(pipe.run_tum(
                ds if kind == "tum_adaptive" else TumDataset.open(root / "tum"), n_fps))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fps[kind].append(n_fps / wall)
        out["host"][kind].append(tuple(1e3 * x / n_fps for x in (
            wall, time.thread_time() - c0, time.process_time() - p0)))
        del pipe
    out["fps"] = fps
    return out


def sift_extractor_bound(ext, H: int, W: int) -> tuple:
    """The least time the SIFT extractor of one HxW frame could take on an
    H100: (ms, "bytes" or "operations"). Bytes: the grey image and the
    feature depth read once, the K keypoints (uv, xyz, score, theta, 128
    descriptor floats, valid, level) written once. Operations, float32 a
    pixel of each octave: the separable Gaussian stack (two passes of 2r+1
    multiply-adds per blur), the DoG differences, the 3x3x3 extremum test
    (26 comparisons twice), the Hessian edge test (~20) and the gradients
    of the interior scales (~20, sqrt and atan2 counted as one each); and a
    keypoint's orientation window (289 bilinear samples of magnitude and
    angle, ~30 each, two histogram adds) and descriptor (256 samples,
    ~40 each with the rotation) with its normalizations; the resize of each
    octave (two passes, ~4 a pixel)."""
    import math

    from rgbdslam_v2_tpu_torch.ops.image import gaussian_kernel_1d

    k = 2.0 ** (1.0 / ext.n_scales)
    sig = [ext.sigma0 * k**i for i in range(ext.n_scales + 3)]
    incs = [sig[0]] + [math.sqrt(sig[i] ** 2 - sig[i - 1] ** 2) for i in range(1, len(sig))]
    taps = sum(len(gaussian_kernel_1d(s_)) for s_ in incs)
    ops, h, w = 0.0, H, W
    for o in range(ext.n_octaves):
        if o:
            h, w = h // 2, w // 2
            ops += 4 * h * w * 2
        n_s = ext.n_scales
        ops += h * w * (2 * 2 * taps + (n_s + 2) + n_s * (52 + 20 + 20))
        ops += ext.octave_budget(o) * (289 * (2 * 30 + 2) + 36 * 8 + 256 * (2 * 40 + 2) + 128 * 6)
    K = ext.max_keypoints
    nbytes = 2 * H * W * 4 + K * (2 + 3 + 1 + 1 + 128) * 4 + K * (1 + 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def family_phase(poses, rgbs, depths, stamps, dev, orb_l4: float, n_sift: int, n_fam: int,
                 n_dtype: int) -> dict:
    """Phase 13: the feature families on make_pipe (see the docstring)."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.models.orb import feature_depth_map
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    out = {}
    torch.cuda.empty_cache()
    sl = slice(0, n_sift)
    s = bench_config_run(poses[sl], rgbs[sl], depths[sl], stamps[sl], dev, keep=True,
                         **FAMILY_PARAMS["SIFTGPU"])
    mgr = s.pop("pipe").manager
    ext = mgr.extractor
    # the extractor alone on one frame, eager: device ms and activities
    k = min(WARMUP, n_sift - 1)
    gray = (torch.from_numpy(rgbs[k]).to(dev).float()
            @ torch.tensor([0.299, 0.587, 0.114], device=dev)) / 255.0
    z = torch.from_numpy(depths[k].astype(np.float32) / 5000.0).to(dev)
    fdepth = feature_depth_map(z, z > 0, False)

    def extract():
        return ext(gray, fdepth, TUM_DEFAULT)

    s["ext_ms"], s["ext_ops"] = device_ms(extract), device_ops(extract)
    s["ext_bound"] = sift_extractor_bound(ext, *gray.shape)
    # one captured 4-frame step replayed again after the run (it rewrites
    # its group's node rows and edge slots with the same values): device
    # ms and activities a frame of the whole SIFT step
    cap = next(c for key, c in mgr.step_graph._graphs.items() if key[0] == 4)
    s["step_ms"] = device_ms(cap.graph.replay, n=5) / 4
    s["step_ops"] = device_ops(cap.graph.replay) / 4
    s["store_mib"] = mgr.store.desc.numel() * mgr.store.desc.element_size() / 2**20
    out["SIFTGPU"] = s
    del mgr, ext, cap
    torch.cuda.empty_cache()

    # replayed groups against eager single steps, SIFT (phase 7's check)
    runs = {}
    sl = slice(0, min(EQUAL_FRAMES, n_sift))
    for n in (1, 4):
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(
            tpu_candidate_batch=4, optimizer_skip_step=100, tpu_frames_per_step=n,
            **FAMILY_PARAMS["SIFTGPU"]), device=dev)
        pipe.run_arrays(rgbs[sl], depths[sl], stamps[sl], gt_poses=poses[sl])
        runs[n] = (pipe.manager.poses(), pipe.manager.statistics(),
                   pipe.manager.step_graph.replays)
        del pipe
    out["sift_equal"] = dict(diff=float(np.abs(runs[4][0] - runs[1][0]).max()),
                             replays=runs[4][2], stats_equal=runs[4][1] == runs[1][1],
                             frames=sl.stop)

    # BRISK and FREAK against phase 6's ORB
    sl = slice(0, n_fam)
    for fam in ("BRISK", "FREAK"):
        torch.cuda.empty_cache()
        out[fam] = bench_config_run(poses[sl], rgbs[sl], depths[sl], stamps[sl], dev,
                                    **FAMILY_PARAMS[fam])
    out["family_l4_max"] = max(2 * orb_l4, orb_l4 + 0.005)

    # ORB descriptor stores, one frame a step (eager steps: a CUDA graph
    # is captured for groups of more than one frame), no online optimize
    sl = slice(0, n_dtype)
    dt = {}
    for dtype in ("int8", "bf16", "float32"):
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(
            tpu_frames_per_step=1, tpu_encode_ahead=False, optimizer_skip_step=100,
            tpu_descriptor_dtype=dtype), device=dev)
        pipe.run_arrays(rgbs[sl], depths[sl], stamps[sl], gt_poses=poses[sl])
        m = pipe.manager
        dt[dtype] = (m.poses(), m.statistics(), str(m.store.desc.dtype))
        del pipe, m
    out["dtypes"] = {d: dict(diff=float(np.abs(dt[d][0] - dt["int8"][0]).max()),
                             stats_equal=dt[d][1] == dt["int8"][1], dtype=dt[d][2],
                             edges=dt[d][1]["sequential_edges"])
                     for d in ("int8", "bf16", "float32")}
    out["dtype_frames"] = sl.stop
    return out


def replay_vs_eager(poses, rgbs, depths, stamps, dev, n: int, **over) -> dict:
    """Phase 7's check on make_pipe_params(tpu_candidate_batch=4,
    optimizer_skip_step=100, **over): n frames a step replayed against one
    frame a step, eager, on the same frames: max pose difference, whether
    the statistics are equal, replays, and each run's wire byte lengths."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    runs = {}
    for k in (1, n):
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(
            tpu_candidate_batch=4, optimizer_skip_step=100, tpu_frames_per_step=k, **over),
            device=dev)
        lengths, encode = [], pipe.manager.encode
        pipe.manager.encode = lambda *a: lengths.append(len(w := encode(*a))) or w
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        runs[k] = (pipe.manager.poses(), pipe.manager.statistics(),
                   pipe.manager.step_graph.replays, lengths)
        del pipe
    return dict(diff=float(np.abs(runs[n][0] - runs[1][0]).max()),
                stats_equal=runs[n][1] == runs[1][1], active=runs[n][1]["active_edges"],
                replays=runs[n][2], lengths=runs[n][3], lengths_equal=runs[n][3] == runs[1][3])


def wire_counts(lengths, cam) -> tuple:
    """(I wires, P wires, mean bytes a frame) of a delta-wire run."""
    from rgbdslam_v2_tpu_torch.graph import ingest

    n_i = sum(n == ingest.wire_intra_len(cam.height, cam.width, 2) for n in lengths)
    n_p = sum(n == ingest.wire_delta_len(cam.height, cam.width, 2) for n in lengths)
    return n_i, n_p, sum(lengths) / max(len(lengths), 1)


def options_phase(poses, rgbs, depths, stamps, dev, frames: int) -> dict:
    """Phase 14: each of OPTIONS on make_pipe (and OPTION_DEFAULT on
    default_params()) as bench_config_run drives phase 6, at most `frames`
    frames each, once for each RANSAC seed of OPTION_SEEDS; the 644x484
    option on its own render, with the fallback's warning captured. Returns
    {name: [one run a seed]}, and "equal": the replay checks."""
    import logging

    from rgbdslam_v2_tpu_torch.config import ParameterServer
    from rgbdslam_v2_tpu_torch.core.camera import Intrinsics
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld

    out = {}
    for name, (n_opt, over, _l4, _flags) in [*OPTIONS.items(), ("default", OPTION_DEFAULT)]:
        n = min(n_opt, frames)
        cam, seq = None, (poses[:n], rgbs[:n], depths[:n], stamps[:n])
        if name == "644x484":
            cam = Intrinsics(*CAM_644)
            seq = render_bench(SyntheticWorld.create(seed=WORLD_SEED, cam=cam), n, dev)
        out[name] = []
        for seed in OPTION_SEEDS:
            warned = []
            handler = logging.Handler(logging.WARNING)
            handler.emit = lambda rec: warned.append(rec.getMessage())
            log = logging.getLogger("rgbdslam.graph")
            log.addHandler(handler)
            try:
                if name == "default":
                    params = ParameterServer(dict(over, tpu_seed=seed))
                    r = bench_config_run(*seq, dev, keep=True, params=params)
                else:
                    r = bench_config_run(*seq, dev, keep=True, cam=cam, tpu_seed=seed, **over)
            finally:
                log.removeHandler(handler)
            mgr = r.pop("pipe").manager
            r.update(frames=n, seed=seed, warnings=warned, fmt=mgr.ingest_fmt,
                     gray_bits=mgr.gray_bits, depth_bits=mgr.depth_bits, delta=mgr.wire_delta)
            out[name].append(r)
            del mgr
    n_eq = min(EQUAL_FRAMES, frames)
    sl = slice(0, n_eq)
    eq = (poses[sl], rgbs[sl], depths[sl], stamps[sl], dev)
    out["equal"] = {
        "delta": replay_vs_eager(*eq, 2, **OPTIONS["delta_clamp_0.3"][1]),
        "g2o_refinement": replay_vs_eager(*eq, 4, **OPTIONS["g2o_refinement"][1]),
    }
    return out


def report_options(op: dict, frames: int) -> None:
    """Phase 14's lines and checks: every option's line prints, then any
    failed check ends the run."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT

    problems = []  # every option's line prints before a failure ends the run
    for name, (_n, _over, l4_jax, flags) in [*OPTIONS.items(), ("default", OPTION_DEFAULT)]:
        runs = op[name]
        limit = option_limit(l4_jax)
        l4 = sum(r["ate"][4] for r in runs) / len(runs)
        host_path = name == "default"
        for r in runs:
            n, st = r["frames"], r["stats"]
            extra = ""
            if name.startswith("delta"):
                n_i, n_p, mean_b = wire_counts(r["wire_lengths"], TUM_DEFAULT)
                r["wires"] = (n_i, n_p, mean_b)
                extra = f"; wires {n_i} I + {n_p} P, {mean_b / 1e3:.1f} kB a frame"
            if name == "644x484":
                extra = f"; ingest {r['fmt']} after the warning {r['warnings'][:1]}"
            if name in ("gray6", "gray5", "raw"):
                extra = (f"; {r['fmt']} {r['gray_bits']}/{r['depth_bits']} bits, "
                         f"{sum(r['wire_lengths']) / len(r['wire_lengths']) / 1e3:.1f} kB a "
                         f"frame, encodes {r['encodes']}")
            phase(f"[14 options] {name} ({flags}), RANSAC seed {r['seed']}, {n} frames: "
                  f"{r['fps']:.2f} fps; ATE L1 {r['ate'][1]:.4f} L4 {r['ate'][4]:.4f} m; nodes "
                  f"{st['nodes']} (dropped {r['dropped']}), accepted edges "
                  f"{st['sequential_edges']} sequential + {st['loop_edges']} loop; launches detect "
                  f"{r['detect_launches']}, refine {r['refine_launches']}, Kabsch "
                  f"{r['kabsch_launches']}; replayed groups {r['replay_groups']}: "
                  f"{r['replay_syncs']} syncs, {r['replay_idle']} idle waits{extra}")
            processed = st["nodes"] + r["dropped"]
            if (processed != n or (not host_path and st["nodes"] != n) or not r["poses_ok"]
                    or not all(np.isfinite(r["ate"]))):
                problems.append(f"option {name}, seed {r['seed']}: {st['nodes']} nodes + "
                                f"{r['dropped']} dropped for {n} frames, ATE {r['ate']}")
            if (r["detect_launches"] != n or r["refine_launches"] != n - 1
                    or r["kabsch_launches"]):
                problems.append(f"option {name}, seed {r['seed']}: launches detect "
                                f"{r['detect_launches']}, refine {r['refine_launches']}, Kabsch "
                                f"{r['kabsch_launches']} for {n} frames")
            if not host_path and (not r["replays"] or r["replay_syncs"] or r["replay_idle"]):
                problems.append(f"option {name}, seed {r['seed']}: {r['replays']} replays; "
                                f"{r['replay_syncs']} syncs ({sorted(set(r['replay_sites']))}) "
                                f"and {r['replay_idle']} idle waits in replayed groups")
        phase(f"[14 options] {name}: L4 {l4:.4f} m, the mean over RANSAC seeds "
              f"{', '.join(str(r['seed']) for r in runs)} (bound {limit:.4f} = max(1.5 x, + 5 mm) "
              f"of the JAX package's mean, seeds 0-3: "
              f"{' / '.join(f'{v:.4f}' for v in l4_jax)})")
        if l4 > limit:
            problems.append(f"option {name}: mean ATE L4 {l4:.4f} m above its bound {limit:.4f}")
    op = {k: (v[0] if k != "equal" else v) for k, v in op.items()}  # seed 0's runs
    if op["644x484"]["fmt"] != "yc12" or not op["644x484"]["warnings"]:
        problems.append(f"644x484 under ydct: ingest {op['644x484']['fmt']}, warnings "
                        f"{op['644x484']['warnings']}")
    if not op["delta"]["delta"] or op["delta"]["gray_bits"] != 6:
        problems.append("the delta wire did not run with its 6/10-bit codes")
    if not op["delta_clamp_0.3"]["wires"][1]:
        problems.append("the delta wire at a clamp budget of 0.3 sent no P wire")
    for name, e in op["equal"].items():
        extra = ""
        if name == "delta":
            n_i, n_p, _ = wire_counts(e["lengths"], TUM_DEFAULT)
            extra = f"; wires {n_i} I + {n_p} P, equal in both runs: {e['lengths_equal']}"
            if not n_p or not e["lengths_equal"]:
                problems.append(f"delta replay check: {n_p} P wires, wires equal "
                                f"{e['lengths_equal']}")
        phase(f"[14 options] {name}: {'2' if name == 'delta' else '4'} frames a step replayed "
              f"({e['replays']} replays) vs 1 frame a step eager, {min(EQUAL_FRAMES, frames)} "
              f"frames: max pose difference {e['diff']:.3e}; statistics equal: "
              f"{e['stats_equal']}{extra}")
        if not e["replays"] or e["diff"] > 1e-6 or not e["stats_equal"]:
            problems.append(f"{name}: the replayed groups differ from the eager steps")
    if problems:
        fail("; ".join(problems))


# phase 15: the bag and cloud inputs, batch evaluation and F22's group length
BAG_FRAMES = 120  # frames written as a bag (~2.15 MB a frame: rgb8 + 32FC1)
PCD_FRAMES = 60  # frames written as organized binary PCDs (~4.9 MB a frame)
EVAL_FRAMES = 60  # frames of each batch-evaluation run
BAG_DECODE_FRAMES = 20  # frames whose arrays are decoded from the bag alone, timed
# F22: tpu_frames_per_step=3 on EQUAL_FRAMES frames fed in chunks whose
# tails hold 2 frames, so that both group lengths are captured and replayed
F22_CHUNKS = (12, 11, 11, 11, 11, 4)


def f22_run(poses, rgbs, depths, stamps, dev) -> dict:
    """Phase 15's F22 check: make_pipe_params(tpu_candidate_batch=4,
    optimizer_skip_step=100) at 3 frames a step replayed against 1 frame a
    step eager (phase 7's check), both fed F22_CHUNKS frames a run_arrays
    call; the 3-a-step run's group lengths, whether each group only
    replayed, and the synchronizing calls in replayed groups."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    runs, groups = {}, []
    for k in (1, 3):
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(
            tpu_candidate_batch=4, optimizer_skip_step=100, tpu_frames_per_step=k), device=dev)
        if k == 3:
            syncs = watch_groups(pipe)
            watched = pipe._process_group

            def sized(compacts, tss, watched=watched, syncs=syncs):
                before = len(syncs["replay"])
                watched(compacts, tss)
                groups.append((len(compacts), len(syncs["replay"]) > before))

            pipe._process_group = sized
        start = 0
        for m in F22_CHUNKS:
            sl = slice(start, start + m)
            pipe.run_arrays(rgbs[sl], depths[sl], stamps[sl], gt_poses=poses[sl])
            start += m
        runs[k] = (pipe.manager.poses(), pipe.manager.statistics(), pipe.manager.step_graph)
        del pipe
    replayed = {n: sum(1 for g, r in groups if g == n and r) for n in (2, 3)}
    return dict(diff=float(np.abs(runs[3][0] - runs[1][0]).max()),
                stats_equal=runs[3][1] == runs[1][1], frames=sum(F22_CHUNKS),
                lengths=sorted({g for g, _ in groups}), replayed=replayed,
                groups=len(groups), captures=runs[3][2].captures, replays=runs[3][2].replays,
                replay_syncs=sum(len(x) for x, *_ in syncs["replay"]),
                replay_idle=sum(i for *_, (_, i) in syncs["replay"]))


def bag_phase(poses, rgbs, depths, stamps, dev, root: Path) -> dict:
    """Phase 15: the bench frames through the port's bag and point-cloud
    inputs and batch evaluation (see the module docstring), in root, where
    phase 12 left its two TUM directories. Every check that fails calls
    fail(); returns the numbers to print."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT, backproject_grid
    from rgbdslam_v2_tpu_torch.eval.ate import evaluate_ate
    from rgbdslam_v2_tpu_torch.io.cloud_input import CloudDataset
    from rgbdslam_v2_tpu_torch.io.pointcloud import write_pcd
    from rgbdslam_v2_tpu_torch.io.rosbag import (pair_rgbd_messages, read_tf_trajectory,
                                                 write_rgbd_bag)
    from rgbdslam_v2_tpu_torch.io.tum import read_trajectory_file
    from rgbdslam_v2_tpu_torch.ops import detect, registration
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline
    from rgbdslam_v2_tpu_torch.pipeline.batch_eval import evaluate_sequences

    def reset():
        detect.reset_launches()
        registration.reset_launches()
        alignment.reset_launches()

    def launches():
        return detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES

    out = {}
    # the u16 counts as the bag carries them: 32FC1 meters, counts / 5000
    meters = depths.astype(np.float32) / np.float32(5000.0)

    # ---- the bag: written, paired, decoded, through the CLI --------------
    n = out["bag_frames"] = min(BAG_FRAMES, len(rgbs))
    bag = root / "bench.bag"
    t0 = time.perf_counter()
    write_rgbd_bag(bag, stamps[:n], rgbs[:n], depths[:n], gt_poses=poses[:n],
                   gt_child_frame="/kinect")
    out["bag_write_s"] = time.perf_counter() - t0
    out["bag_mib"] = bag.stat().st_size / 2**20
    t0 = time.perf_counter()
    pairs = pair_rgbd_messages(bag)
    out["pair_s"] = time.perf_counter() - t0
    if len(pairs) != n:
        fail(f"bag: {len(pairs)} RGB-D pairs for {n} frames")
    bag_stamps = [r.stamp for r, _ in pairs]
    m = min(BAG_DECODE_FRAMES, n)
    t0 = time.perf_counter()
    decoded = [(r.as_array(), d.as_array()) for r, d in pairs[:m]]
    out["decode_ms"] = 1e3 * (time.perf_counter() - t0) / m
    bad = [i for i, (rgb, d) in enumerate(decoded)
           if not (np.array_equal(rgb, rgbs[i]) and np.array_equal(d, meters[i]))]
    del pairs, decoded
    if bad:
        fail(f"bag: frames {bad} decode unequal to the written RGB and meters")

    res, ref_dir = root / "bag_out", root / "bag_ref"
    reset()
    t0 = time.perf_counter()
    code, text, pipe = run_cli(["run", "--bagfile", bag, "--out", res, "--evaluate",
                                "--save-bag", "-p", "ground_truth_frame_name=/kinect",
                                *make_pipe_flags()])
    out["cli_s"] = time.perf_counter() - t0
    out["launches"] = launches()
    if code != 0 or pipe is None:
        fail(f"rgbdslam-torch run --bagfile exited {code}: {text[-2000:]}")
    report = json.loads((res / "estimate_report.json").read_text())
    out["ate"] = [report["ate_rmse"].get(str(lvl), float("nan")) for lvl in range(5)]
    out["stats"] = report["statistics"]
    replay = pipe.group_syncs["replay"]
    out["replay_groups"], out["replay_syncs"] = len(replay), sum(len(x) for x, *_ in replay)
    if out["launches"][0] != n or out["launches"][1] != n - 1:
        fail(f"bag entry: detect launched {out['launches'][0]}, refine "
             f"{out['launches'][1]} times for {n} frames")
    # the report's ATE (ground truth from /tf) against the rendered poses
    out["ate_rendered"] = []
    for lvl in range(5):
        rows = read_trajectory_file(res / f"estimate_iteration_{lvl}.txt")
        out["ate_rendered"].append(
            evaluate_ate(rows[:, 0], rows[:, 1:4], bag_stamps, poses[:n, :3, 3]).rmse)
    out["ate_diff"] = max(abs(a - b) for a, b in zip(out["ate"], out["ate_rendered"]))
    # ATE_L4_MAX holds the whole 520-frame orbit, whose loops close; on
    # these 120 frames the bag run is held to run_arrays (below) instead
    if not all(np.isfinite(out["ate"])):
        fail(f"bag entry ATE {out['ate']}: not finite")
    if not out["ate_diff"] <= 1e-6:
        fail(f"bag entry: the report's ATE {out['ate']} against the rendered poses' "
             f"{out['ate_rendered']}")
    # result.bag: one tf a node at its pose
    tf_stamps, tf_rows = read_tf_trajectory(res / "result.bag", child_frame="/camera")
    est = pipe.manager.poses()
    out["result_bag_diff"] = (float(np.abs(tf_rows[:, :3] - est[:, :3, 3]).max())
                              if len(tf_rows) == len(est) else float("inf"))
    if len(tf_stamps) != pipe.manager.n_nodes or not out["result_bag_diff"] <= 1e-6:
        fail(f"result.bag: {len(tf_stamps)} tf for {pipe.manager.n_nodes} nodes, positions "
             f"{out['result_bag_diff']:.3e} m from the trajectory")
    del pipe
    ref = SlamPipeline(TUM_DEFAULT, make_pipe_params(), device=dev)
    ref.run_arrays(rgbs[:n], meters[:n], bag_stamps)
    out["ref_l4"] = ref.evaluation_protocol(ref_dir, gt_stamps=bag_stamps,
                                            gt_xyz=poses[:n, :3, 3]).ate_rmse[4]
    del ref
    out["traj_diff"] = against_arrays(res, ref_dir)
    if max(out["traj_diff"]) > 1e-5:
        fail(f"bag entry against run_arrays: trajectory files differ by {out['traj_diff']} "
             f"(limit 1e-5)")
    # fps: run_bag against run_arrays on the same frames, alternating
    fps = out["fps"] = {"bag": [], "arrays": []}
    for kind in ("bag", "arrays") * 2:
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "bag":
            pipe.run_bag(bag)
        else:
            pipe.run_arrays(rgbs[:n], meters[:n], bag_stamps)
        torch.cuda.synchronize()
        fps[kind].append(n / (time.perf_counter() - t0))
        del pipe
    bag.unlink()

    # ---- organized PCDs: written, loaded, through the CLI ----------------
    k = out["pcd_frames"] = min(PCD_FRAMES, len(rgbs))
    pcd = root / "pcd"
    pcd.mkdir()
    t0 = time.perf_counter()
    for i in range(k):
        pts = backproject_grid(torch.from_numpy(meters[i]).to(dev), TUM_DEFAULT).cpu().numpy()
        pts[meters[i] <= 0] = np.nan  # invalid depth as NaN rows, as PCL writes them
        write_pcd(pcd / f"{stamps[i]:.6f}.pcd", pts.reshape(-1, 3), rgbs[i].reshape(-1, 3),
                  organized_hw=meters.shape[1:3])
    out["pcd_write_ms"] = 1e3 * (time.perf_counter() - t0) / k
    out["pcd_mib"] = sum(f.stat().st_size for f in pcd.iterdir()) / 2**20
    ds = CloudDataset.open(pcd, TUM_DEFAULT)
    t0 = time.perf_counter()
    bad = []
    for i in range(k):
        _ts, rgb, depth = ds.load(i)
        if not (np.array_equal(rgb, rgbs[i]) and np.array_equal(depth, meters[i])):
            bad.append(i)
    out["pcd_load_ms"] = 1e3 * (time.perf_counter() - t0) / k
    if bad or len(ds) != k:
        fail(f"PCD input: {len(ds)} files; frames {bad[:5]} load unequal to the rendered "
             f"RGB and depth")
    res, ref_dir = root / "pcd_out", root / "pcd_ref"
    reset()
    t0 = time.perf_counter()
    code, text, pipe = run_cli(["run", "--pcd-dir", pcd, "--out", res, "--evaluate",
                                *make_pipe_flags()])
    out["pcd_cli_s"] = time.perf_counter() - t0
    out["pcd_launches"] = launches()
    if code != 0 or pipe is None:
        fail(f"rgbdslam-torch run --pcd-dir exited {code}: {text[-2000:]}")
    del pipe
    if out["pcd_launches"][0] != k or out["pcd_launches"][1] != k - 1:
        fail(f"PCD entry: detect launched {out['pcd_launches'][0]}, refine "
             f"{out['pcd_launches'][1]} times for {k} frames")
    ref = SlamPipeline(TUM_DEFAULT, make_pipe_params(), device=dev)
    ref.run_arrays(rgbs[:k], meters[:k], ds.stamps)
    ref.evaluation_protocol(ref_dir)
    del ref
    out["pcd_traj_diff"] = against_arrays(res, ref_dir)
    if max(out["pcd_traj_diff"]) > 1e-5:
        fail(f"PCD entry against run_arrays: trajectory files differ by "
             f"{out['pcd_traj_diff']} (limit 1e-5)")
    shutil.rmtree(pcd)

    # ---- batch evaluation over phase 12's TUM directories ----------------
    configs = {"make_pipe": dict(MAKE_PIPE),
               "one_a_step": dict(MAKE_PIPE, tpu_ingest_format="yc12", tpu_gray_bits=8,
                                  tpu_frames_per_step=1, tpu_encode_ahead=False,
                                  tpu_drain_pipelined=False)}
    reset()
    t0 = time.perf_counter()
    results = evaluate_sequences([("up", root / "tum"), ("adaptive", root / "tum_adaptive")],
                                 TUM_DEFAULT, configs=configs, out_dir=root / "batch",
                                 max_frames=EVAL_FRAMES, device=dev)
    out["batch_s"] = time.perf_counter() - t0
    out["batch_launches"] = launches()
    rows = (root / "batch" / "summary.csv").read_text().splitlines()
    out["batch"] = [(r.name, r.config, r.ate_by_level.get(4, float("nan")), r.fps, r.nodes)
                    for r in results]
    n_eval = min(EVAL_FRAMES, len(rgbs))
    if (len(rows) != 5 or not rows[0].startswith("sequence,config,ate_L0")
            or not all(np.isfinite(r[2]) for r in out["batch"])
            or any(r[4] != n_eval for r in out["batch"])):
        fail(f"batch evaluation: summary.csv {rows}, results {out['batch']}")
    if out["batch_launches"][0] != 4 * n_eval or out["batch_launches"][1] != 4 * (n_eval - 1):
        fail(f"batch evaluation: launches {out['batch_launches']} for 4 runs of {n_eval}")

    # ---- F22: three frames a step ----------------------------------------
    f = min(EQUAL_FRAMES, len(rgbs))
    reset()
    out["f22"] = f22 = f22_run(poses[:f], rgbs[:f], depths[:f], stamps[:f], dev)
    out["f22_launches"] = launches()
    if (f22["diff"] > 1e-6 or not f22["stats_equal"] or f22["lengths"] != [2, 3]
            or not all(f22["replayed"].values()) or f22["replay_syncs"]
            or f22["replay_idle"]):
        fail(f"tpu_frames_per_step=3: {f22}")
    return out


# phase 16: loop retrieval, robot odometry, landmark BA, empirical
# covariances, the stereo input and the mesh output
RETRIEVAL = dict(global_loop_candidates=2)
# the replay = eager runs: room among the candidates for the retrieval's
# hits (make_pipe's 4 predecessors and 4 geodesic neighbours fill its 8
# slots once the graph has grown) and no online optimize
RETRIEVAL_EQUAL = dict(global_loop_candidates=2, neighbor_candidates=1, min_sampled_candidates=0,
                       optimizer_skip_step=100)
RETRIEVAL_STORES = (1024, 4096)  # node capacities of the filled stores
RETRIEVAL_FLIP = 0.03  # bits flipped in each further copy of a tiled node
RETRIEVAL_FPS_FRAMES = 260  # frames of each clean-process fps run
HOST_FRAMES = 60  # the default path with retrieval; the odometry runs
STEREO_FRAMES = 120
STEREO_BASELINE = 0.075  # metres (stereo_baseline's default)
STEREO_SEED = 1  # synthetic --seed: world 1, orbit seed 2
STEREO_CHECK_FRAMES = (0, 60, 119)  # pairs whose disparity runs on the card and the CPU
# The JAX package's protocol L4 (m) with RANSAC seeds 0-3 (tpu_seed) on the
# same frames, on the CPU; the bound is max(1.5 x, + 5 mm) of their mean
# (option_limit). Stereo: the JAX CLI on its own synthetic --stereo render,
#   JAX_PLATFORMS=cpu python -m rgbdslam_v2_tpu.apps.cli synthetic --out D
#       --frames 120 --seed 1 --stereo 0.075
#   JAX_PLATFORMS=cpu python -m rgbdslam_v2_tpu.apps.cli run --stereo-dir D
#       --out O --camera default --evaluate -p stereo_baseline=0.075
#       -p tpu_seed=S [make_pipe_flags()]
# The default path with retrieval on the bench orbit's first 60 frames:
#   JAX_PLATFORMS=cpu python3 tools/make_pipe_same_frames.py --packages jax
#       --seeds 0 1 2 3 --frames 60 --config default
#       --set global_loop_candidates=2
STEREO_L4_JAX = (0.0092, 0.0089, 0.0089, 0.0097)
HOST_RETRIEVAL_L4_JAX = (0.0107, 0.0109, 0.0105, 0.0116)
RETRIEVAL_FLOPS_PER_TERM = 2  # a multiply and an add of the float32 distance matmul


def phase16_reset():
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.ops import detect, registration

    detect.reset_launches()
    registration.reset_launches()
    alignment.reset_launches()


def phase16_launches() -> tuple:
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.ops import detect, registration

    return detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES


def filled_store(store, n: int, N: int, seed: int = 0):
    """A store of N nodes on store's device whose rows tile store's first n
    (keypoints, descriptors, validity); each further copy of a row has
    RETRIEVAL_FLIP of its descriptor signs flipped, so the copies are near
    matches of one another and not ties. The depth and colour planes are
    left out (one column): retrieval reads none of them."""
    import torch
    from rgbdslam_v2_tpu_torch.graph.node_store import NodeStore

    dev = store.desc.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    idx = torch.arange(N, device=dev) % n
    desc = store.desc[idx].clone()
    flip = (torch.rand(desc.shape, generator=gen, device=dev) < RETRIEVAL_FLIP)
    flip &= (torch.arange(N, device=dev) >= n)[:, None, None]
    desc = torch.where(flip, -desc, desc)
    one = torch.zeros((N, 1), device=dev)
    return NodeStore(uv=store.uv[idx].clone(), xyz=store.xyz[idx].clone(), desc=desc,
                     kp_valid=store.kp_valid[idx].clone(), depth=one,
                     emm_lohi=one.to(torch.int32), color=one.to(torch.uint8))


def retrieval_numbers(store, n_nodes: int, queries, plain_rows: int = 0) -> dict:
    """One deferred retrieval (global_match_scores_from_store) against
    store's first n_nodes nodes: its counts against the capacity-wide plain
    version for each query id (equal, or it fails), its device ms (profiler,
    mean of 3 calls) and event span, the peak memory it adds, and its bound
    (the store rows and the query read once, the counts written once, or
    the float32 matmul's multiply-adds at 67 TFLOP/s, the larger)."""
    import torch
    from rgbdslam_v2_tpu_torch.graph import loop_closing as lc

    N, K, D = store.desc.shape
    out = {"n_nodes": n_nodes, "capacity": N, "nonzero": 0}
    for q in queries:
        got = lc.global_match_scores_from_store(store, q, n_nodes)
        plain = lc.global_match_scores_plain(
            lc.query_from_store(store, q), store, torch.arange(N, device=store.desc.device)
            < n_nodes, lc.exclude_window_mask(N, q, 8, store.desc.device),
            query_rows=plain_rows)
        if not torch.equal(got, plain):
            fail(f"retrieval at {n_nodes} of {N} nodes, query {q}: chunked counts differ from "
                 f"the plain version's at {int((got != plain).sum())} nodes")
        out["nonzero"] += int((got > 0).sum())
    q = queries[-1]

    def call():
        return lc.global_match_scores_from_store(store, q, n_nodes)

    out["ms"] = device_ms(call, n=3)
    out["event_ms"] = median_ms(call, n=3)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    esize = store.desc.element_size()
    nbytes = K * D * esize + n_nodes * K * (D * esize + 1) + N * 4
    flops = RETRIEVAL_FLOPS_PER_TERM * K * n_nodes * K * D
    out["bound_ms"], out["bound_by"] = max(
        (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (flops / 67e12 * 1e3, "operations"))
    out["gflop"] = flops / 1e9
    return out


def retrieval_replay_vs_eager(poses, rgbs, depths, stamps, dev) -> dict:
    """make_pipe_params(**RETRIEVAL_EQUAL) at 4 frames a step, the groups
    replayed as CUDA graphs against the same groups run eagerly (the
    manager without its StepGraph): max pose difference, equal statistics
    and retrieval hits."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    runs = {}
    for kind in ("replay", "eager"):
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(**RETRIEVAL_EQUAL), device=dev)
        if kind == "eager":
            pipe.manager.step_graph = None
        pipe.run_arrays(rgbs, depths, stamps, gt_poses=poses)
        m = pipe.manager
        runs[kind] = (m.poses(), m.statistics(), m.retrievals, m.retrieval_hits,
                      0 if m.step_graph is None else m.step_graph.replays)
        del pipe, m
    (pr, sr, rr, hr, nr), (pe, se, re_, he, _) = runs["replay"], runs["eager"]
    return dict(diff=float(np.abs(pr - pe).max()), stats_equal=sr == se, replays=nr,
                retrievals=(rr, re_), hits=(hr, he), loop_edges=sr["loop_edges"],
                frames=len(rgbs))


def clean_process_fps(poses, rgbs, depths, stamps, root: Path) -> dict:
    """tools/make_pipe_fps.py on the first RETRIEVAL_FPS_FRAMES frames, one
    process a run: plain make_pipe, then make_pipe with RETRIEVAL."""
    import numpy as np

    n = min(RETRIEVAL_FPS_FRAMES, len(rgbs))
    d = root / "fps_frames"
    d.mkdir()
    for name, arr in (("poses", poses), ("rgbs", rgbs), ("depths", depths), ("stamps", stamps)):
        np.save(d / f"{name}.npy", np.ascontiguousarray(arr[:n]))
    out = {"plain": [], "retrieval": [], "frames": n}
    for name in ("plain", "retrieval"):
        sets = [x for k, v in RETRIEVAL.items() for x in ("--set", f"{k}={v}")] \
            if name == "retrieval" else []
        r = subprocess.run([sys.executable, str(ROOT / "tools" / "make_pipe_fps.py"), str(d),
                            *sets], capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"tools/make_pipe_fps.py ({name}) exited {r.returncode}: {r.stderr[-2000:]}")
        out[name].append(json.loads(r.stdout.strip().splitlines()[-1]))
    shutil.rmtree(d)
    return out


def loop_spans(mgr) -> list:
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_LOOP

    return [abs(p[0] - p[1]) for t, p in zip(mgr.host.edge_types, mgr.host.edge_pairs)
            if t == EDGE_LOOP and p is not None]


def host_path_run(poses, rgbs, depths, stamps, dev, params) -> dict:
    """`params` (a default-path configuration) frame by frame, as
    tools/make_pipe_same_frames.py drives it (WARMUP frames, a blocking
    optimize, the rest), each frame's synchronizing calls recorded outside
    the online optimize (which reads its convergence flag on this path),
    with the retrievals it ran; then the protocol."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    pipe = SlamPipeline(TUM_DEFAULT, params, device=dev)
    mgr = pipe.manager
    online = mgr.optimize

    def unwatched_optimize(*a, **kw):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return online(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    mgr.optimize = unwatched_optimize
    frames, t0 = [], time.perf_counter()
    for i in range(len(rgbs)):
        before = mgr.retrievals
        sites = sync_sites(lambda: pipe.process_frame(
            rgbs[i], depths[i], float(stamps[i]), gt_pose=poses[0] if i == 0 else None))
        frames.append(([s.split(":")[0] for s in sites], mgr.retrievals - before))
        if i == WARMUP - 1:
            online(blocking=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del mgr.optimize
    with tempfile.TemporaryDirectory() as td:
        rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps), gt_xyz=poses[:, :3, 3])
    est = mgr.poses()
    return dict(pipe=pipe, frames=frames, wall=wall, stats=rep.statistics,
                ate=[rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)],
                poses_ok=bool(np.isfinite(est).all()))


def cpu_copy(pipe):
    """A CPU pipeline with the same camera and parameters holding a copy of
    pipe's store and graph (and sharing its host bookkeeping)."""
    import dataclasses

    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    cpu = SlamPipeline(pipe.cam, pipe.params, device="cpu")
    src, dst = pipe.manager, cpu.manager
    for a, b in ((src.store, dst.store), (src.graph, dst.graph)):
        for f in dataclasses.fields(a):
            getattr(b, f.name).copy_(getattr(a, f.name).cpu())
    dst.host = src.host
    return cpu


def stereo_bound(H: int, W: int, D: int, block: int) -> tuple:
    """(bound ms, by) of stereo_depth at H x W: the two grey images read
    once and the depth and validity written once, or the volume's float32
    operations (a pixel a disparity: the difference, its magnitude and two
    box sums of block - 1 adds each, the argmins' comparisons of the left
    and the right views, the mean's add) at 67 TFLOP/s."""
    nbytes = 2 * H * W * 4 + H * W * (4 + 1)
    ops = H * W * D * (2 + 2 * (block - 1) + 2 + 1)
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / 67e12 * 1e3, "operations"))


def stereo_phase(dev, root: Path, n: int) -> dict:
    """Phase 16's stereo input and mesh output on n frames: synthetic
    --stereo, the front end on the card against the CPU, run --stereo-dir
    --evaluate --save-mesh with make_pipe (L4 held to the JAX package's
    when n is STEREO_FRAMES), the mesh against the CPU's."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.apps import cli
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io.meshing import read_ply_mesh
    from rgbdslam_v2_tpu_torch.io.stereo_input import StereoDataset
    from rgbdslam_v2_tpu_torch.ops import stereo

    out = {}
    seq, res = root / "stereo", root / "stereo_out"
    t0 = time.perf_counter()
    code = cli.main(["synthetic", "--out", str(seq), "--frames", str(n), "--seed",
                     str(STEREO_SEED), "--stereo", str(STEREO_BASELINE)])
    out["synthetic_s"] = time.perf_counter() - t0
    if code != 0:
        fail(f"rgbdslam-torch synthetic --stereo exited {code}")
    ds = StereoDataset.open(seq)
    if len(ds) != n:
        fail(f"synthetic --stereo wrote {len(ds)} pairs for {n} frames")
    valid_eq, disp_eq = [], []
    for k in STEREO_CHECK_FRAMES:
        _ts, _rgb, gl, gr = ds.load(min(k, len(ds) - 1))
        pair = torch.from_numpy(np.stack([gl, gr]))
        cd, cv = stereo.disparity_block_matching(pair[0].to(dev), pair[1].to(dev))
        hd, hv = stereo.disparity_block_matching(pair[0], pair[1])
        valid_eq.append(float((cv.cpu() == hv).float().mean()))
        disp_eq.append(float((cd.cpu() == hd).float().mean()))
    out["valid_eq"], out["disp_eq"] = valid_eq, disp_eq
    out["valid_share"] = float(hv.float().mean())
    if min(valid_eq) < 0.999 or min(disp_eq) < 0.999:
        fail(f"stereo disparity on the card against the CPU: valid equal on {valid_eq}, "
             f"disparity equal on {disp_eq} of the pixels (at least 0.999)")
    left, right = pair[0].to(dev), pair[1].to(dev)

    def front():
        return stereo.stereo_depth(left, right, TUM_DEFAULT.fx, STEREO_BASELINE)

    out["front_ms"], out["front_event_ms"] = device_ms(front, n=10), median_ms(front, n=10)
    out["front_ops"] = device_ops(front)
    out["front_bound"] = stereo_bound(TUM_DEFAULT.height, TUM_DEFAULT.width, 64, 9)
    del left, right, pair
    phase16_reset()
    t0 = time.perf_counter()
    code, text, pipe = run_cli(["run", "--stereo-dir", seq, "--out", res, "--camera", "default",
                                "--evaluate", "--save-mesh", "-p",
                                f"stereo_baseline={STEREO_BASELINE}", *make_pipe_flags()])
    out["cli_s"] = time.perf_counter() - t0
    out["launches"] = phase16_launches()
    if code != 0 or pipe is None:
        fail(f"rgbdslam-torch run --stereo-dir exited {code}: {text[-2000:]}")
    report = json.loads((res / "estimate_report.json").read_text())
    out["ate"] = [report["ate_rmse"].get(str(lvl), float("nan")) for lvl in range(5)]
    out["stats"] = report["statistics"]
    out["run_stereo_s"] = pipe.save_ms["run_stereo"] / 1e3
    out["fps"] = n / out["run_stereo_s"]
    replay = pipe.group_syncs["replay"]
    out["replay_groups"], out["replay_syncs"] = len(replay), sum(len(x) for x, *_ in replay)
    if out["launches"][0] != n or out["launches"][1] != n - 1:
        fail(f"stereo entry: detect launched {out['launches'][0]}, refine "
             f"{out['launches'][1]} times for {n} frames")
    # a second RANSAC seed (OPTION_SEEDS' rule: one seed moves L4 up to 2x)
    code, text2, pipe2 = run_cli(["run", "--stereo-dir", seq, "--out", root / "stereo_seed1",
                                  "--camera", "default", "--evaluate", "-p",
                                  f"stereo_baseline={STEREO_BASELINE}", *make_pipe_flags(),
                                  "-p", f"tpu_seed={OPTION_SEEDS[1]}"])
    if code != 0 or pipe2 is None:
        fail(f"rgbdslam-torch run --stereo-dir, seed {OPTION_SEEDS[1]}, exited {code}: "
             f"{text2[-2000:]}")
    del pipe2
    rep2 = json.loads((root / "stereo_seed1" / "estimate_report.json").read_text())
    out["ate_seed1"] = [rep2["ate_rmse"].get(str(lvl), float("nan")) for lvl in range(5)]
    shutil.rmtree(root / "stereo_seed1")
    out["l4_mean"] = (out["ate"][4] + out["ate_seed1"][4]) / 2
    out["limit"] = option_limit(STEREO_L4_JAX) if n == STEREO_FRAMES else float("inf")
    if not all(np.isfinite(out["ate"] + out["ate_seed1"])) or out["l4_mean"] > out["limit"]:
        fail(f"stereo entry ATE {out['ate']} and {out['ate_seed1']} (seeds {OPTION_SEEDS}): not "
             f"finite or the mean L4 above {out['limit']:.4f} m")
    # the mesh: parsed, and the CPU's from the same state
    t0 = time.perf_counter()
    verts, cols, faces = read_ply_mesh(res / "mesh.ply")
    out["mesh_read_s"] = time.perf_counter() - t0
    out["mesh_faces"], out["mesh_verts"] = len(faces), len(verts)
    out["mesh_mib"] = (res / "mesh.ply").stat().st_size / 2**20
    out["mesh_ms"] = pipe.save_ms["save_mesh"]
    if f"saved mesh.ply ({len(faces)} triangles)" not in text or not len(faces):
        fail(f"mesh.ply holds {len(faces)} faces; the CLI printed "
             f"{[ln for ln in text.splitlines() if 'mesh' in ln]}")
    cpu = cpu_copy(pipe)
    cpu.save_mesh(res / "mesh_cpu.ply")
    cv, cc, cf = read_ply_mesh(res / "mesh_cpu.ply")
    out["mesh_vert_diff"] = float(np.abs(cv - verts).max()) if cv.shape == verts.shape \
        else float("inf")
    if not (np.array_equal(cf, faces) and np.array_equal(cc, cols)) \
            or out["mesh_vert_diff"] > 1e-5:
        fail(f"mesh on the card against the CPU: faces equal {np.array_equal(cf, faces)}, "
             f"colours equal {np.array_equal(cc, cols)}, vertices within "
             f"{out['mesh_vert_diff']:.2e} m (limit 1e-5)")
    del cpu, pipe
    shutil.rmtree(seq)
    shutil.rmtree(res)
    return out


def phase16(poses, rgbs, depths, stamps, dev, root: Path) -> dict:
    """Phase 16 (see the module docstring). Every check that fails calls
    fail(); returns the numbers to print."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.config import ParameterServer
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_ODOMETRY
    from rgbdslam_v2_tpu_torch.graph.odometry import OdometryProvider

    out = {"seconds": {}}
    frames = len(rgbs)
    t_part = [time.perf_counter()]

    def mark(name):  # seconds each part took
        now = time.perf_counter()
        out["seconds"][name] = now - t_part[0]
        t_part[0] = now

    # ---- retrieval on make_pipe ----------------------------------------
    r = out["run"] = bench_config_run(poses, rgbs, depths, stamps, dev, keep=True, **RETRIEVAL)
    pipe = r.pop("pipe")
    mgr = pipe.manager
    r["retrievals"], r["hits"] = mgr.retrievals, mgr.retrieval_hits
    spans = loop_spans(mgr)
    r["max_span"] = max(spans, default=0)
    if r["detect_launches"] != frames or r["refine_launches"] != frames - 1:
        fail(f"retrieval run: detect launched {r['detect_launches']}, refine "
             f"{r['refine_launches']} times for {frames} frames")
    if not r["replays"] or r["replay_syncs"] or r["replay_idle"]:
        fail(f"retrieval run: {r['replays']} replays; in {r['replay_groups']} replayed groups "
             f"{r['replay_syncs']} synchronizing calls ({sorted(set(r['replay_sites']))}) and "
             f"{r['replay_idle']} waits that left the card idle")
    if not r["retrievals"] or not r["poses_ok"] or not r["stats"]["loop_edges"]:
        fail(f"retrieval run: {r['retrievals']} retrievals, statistics {r['stats']}")
    if not all(np.isfinite(r["ate"])) or r["ate"][4] > ATE_L4_MAX:
        fail(f"retrieval run ATE {r['ate']}: not finite or L4 above {ATE_L4_MAX} m")
    mark("make_pipe run")
    store, n = mgr.store, mgr.n_nodes
    out["at_run"] = retrieval_numbers(store, n, [n - 1])
    for N in RETRIEVAL_STORES:
        big = filled_store(store, n, N)
        out[f"at_{N}"] = retrieval_numbers(big, N, [N - 1], plain_rows=200)
        del big
    mark("retrieval calls")
    # ---- landmark BA, empirical covariances, graph viz on its graph ---------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["ba"] = mgr.optimize_landmarks()
    torch.cuda.synchronize()
    out["ba_s"] = time.perf_counter() - t0
    if not out["ba"]["landmarks"] or not out["ba"]["chi2_after"] < out["ba"]["chi2_before"]:
        fail(f"landmark BA on the retrieval run's graph: {out['ba']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.set_empirical_covariances()
    torch.cuda.synchronize()
    out["cov_ms"] = 1e3 * (time.perf_counter() - t0)
    act = mgr.graph.edge_active[: mgr.n_edges]
    info = mgr.graph.edge_info[: mgr.n_edges][act]
    out["cov_edges"] = int(act.sum())
    diag = torch.diagonal(info, dim1=-2, dim2=-1)
    if not bool(torch.isfinite(info).all()) or not bool((diag > 0).all()):
        fail("empirical covariances: information not finite or a diagonal not positive")
    with tempfile.TemporaryDirectory() as td:
        out["viz_edges"] = pipe.save_graph_viz(Path(td) / "graph.ply")
    if out["viz_edges"] != r["final_stats"]["active_edges"]:
        fail(f"save_graph_viz wrote {out['viz_edges']} edges for "
             f"{r['final_stats']['active_edges']} active ones")
    mark("BA, covariances, viz")
    del pipe, mgr, store
    gc.collect()
    torch.cuda.empty_cache()
    # ---- replay = eager with retrieval hits taken; fps in clean processes
    f = min(EQUAL_FRAMES, frames)
    eq = out["equal"] = retrieval_replay_vs_eager(poses[:f], rgbs[:f], depths[:f], stamps[:f],
                                                  dev)
    if eq["diff"] != 0.0 or not eq["stats_equal"] or not eq["replays"] or not eq["hits"][0] \
            or eq["hits"][0] != eq["hits"][1]:
        fail(f"retrieval replay against eager: {eq}")
    mark("replay = eager")
    out["fps"] = clean_process_fps(poses, rgbs, depths, stamps, root)
    mark("clean-process fps")
    # ---- the default path with retrieval ----------------------------------
    h = min(HOST_FRAMES, frames)
    phase16_reset()
    hr = out["host"] = host_path_run(poses[:h], rgbs[:h], depths[:h], stamps[:h], dev,
                                     ParameterServer(dict(RETRIEVAL)))
    hr["launches"] = phase16_launches()
    del hr["pipe"]
    for i, (sites, n_ret) in enumerate(hr["frames"][1:], 1):
        if (sites.count("manager.py") != 1 or sites.count("loop_closing.py") != n_ret
                or not set(sites) <= {"manager.py", "loop_closing.py", "backend.py"}):
            fail(f"default path with retrieval, frame {i}: synchronizing calls {sites} with "
                 f"{n_ret} retrievals (expected one in manager.py and one a retrieval in "
                 f"loop_closing.py)")
    hr["limit"] = option_limit(HOST_RETRIEVAL_L4_JAX)
    if not hr["poses_ok"] or not all(np.isfinite(hr["ate"])) or hr["ate"][4] > hr["limit"]:
        fail(f"default path with retrieval: ATE {hr['ate']}, limit L4 <= {hr['limit']:.4f}")
    if hr["launches"][0] != h or hr["launches"][1] != h - 1:
        fail(f"default path with retrieval: launches {hr['launches']} for {h} frames")
    mark("default path")
    # ---- robot odometry on the default path, ground truth as odometry ------
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    odo = out["odometry"] = {}
    for name, over in (("only", dict(use_robot_odom_only=True)),
                       ("visual", dict(use_robot_odom=True))):
        phase16_reset()
        pipe = SlamPipeline(TUM_DEFAULT, ParameterServer(over), device=dev)
        pipe.manager.set_odometry_provider(OdometryProvider(stamps[:h], poses[:h]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_arrays(rgbs[:h], depths[:h], stamps[:h], gt_poses=poses[:h])
        torch.cuda.synchronize()
        m = pipe.manager
        o = odo[name] = dict(fps=h / (time.perf_counter() - t0), launches=phase16_launches(),
                             nodes=m.n_nodes,
                             odometry_edges=m.host.edge_types.count(EDGE_ODOMETRY),
                             edges=len(m.host.edge_types))
        if name == "only":
            o["err"] = float(np.abs(m.poses()[:, :3, 3] - poses[:h, :3, 3]).max())
            if m.n_nodes != h or o["odometry_edges"] != h - 1 or o["edges"] != h - 1 \
                    or o["err"] > 1e-3 or o["launches"][:2] != (h, 0):
                fail(f"odometry only: {o}")
        else:
            with tempfile.TemporaryDirectory() as td:
                rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps[:h]),
                                               gt_xyz=poses[:h, :3, 3])
            o["ate"] = [rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)]
            if o["odometry_edges"] != m.n_nodes - 1 or o["edges"] <= o["odometry_edges"] \
                    or not all(np.isfinite(o["ate"])) or o["ate"][4] > DEFAULT_ATE_L4_MAX \
                    or o["launches"][:2] != (h, h - 1):
                fail(f"visual + odometry: {o}")
        del pipe, m
    mark("odometry")
    # ---- the stereo input and the mesh output ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    out["stereo"] = stereo_phase(dev, root, min(STEREO_FRAMES, frames))
    mark("stereo and mesh")
    return out


def report_phase16(p: dict, frames: int) -> None:
    """Phase 16's lines."""
    r, st = p["run"], p["run"]["stats"]
    phase(f"[16 retrieval] {r['fps']:.2f} fps over {frames - WARMUP} frames; nodes "
          f"{st['nodes']}, edges {st['edges']} ({st['active_edges']} active, "
          f"{st['sequential_edges']} sequential, {st['loop_edges']} loop, longest loop span "
          f"{r['max_span']} frames); retrievals {r['retrievals']} "
          f"({r['retrievals'] / frames:.3f} a frame), hits taken {r['hits']}; detect launches "
          f"{r['detect_launches']}, refine {r['refine_launches']}, Kabsch "
          f"{r['kabsch_launches']}; replays {r['replays']}; synchronizing calls in "
          f"{r['replay_groups']} replayed groups {r['replay_syncs']}, waits for a copy not "
          f"landed {r['replay_waits']} ({r['copy_waits']} in all), of which left the card idle "
          f"{r['replay_idle']}; peak device memory {r['peak_gib']:.2f} GiB; ATE L0..L4 "
          f"{' / '.join(f'{a:.4f}' for a in r['ate'])} m (limit L4 <= {ATE_L4_MAX})")
    for key in ("at_run", *(f"at_{N}" for N in RETRIEVAL_STORES)):
        q = p[key]
        phase(f"[16 retrieval] one retrieval at {q['n_nodes']} of {q['capacity']} nodes "
              f"({'the run' if key == 'at_run' else 'a filled store'}): chunked counts = "
              f"plain ({q['nonzero']} nodes with votes); device {fmt_ms(q['ms'])} (profiler, "
              f"mean of 3), event span {q['event_ms']:.4f} ms; peak added "
              f"{q['peak_mib']:.1f} MiB; bound {q['bound_ms']:.4f} ms ({q['bound_by']}: "
              f"{q['gflop']:.1f} GFLOP float32); share of bound "
              f"{'not measured' if q['ms'] is None else f'{100 * q['bound_ms'] / q['ms']:.1f}%'}")
    eq = p["equal"]
    phase(f"[16 retrieval] {eq['frames']} frames, 4 a step with room for hits "
          f"({RETRIEVAL_EQUAL}): replayed ({eq['replays']} replays) against eager groups: max "
          f"pose difference {eq['diff']:.3e}, statistics equal {eq['stats_equal']}, "
          f"retrievals {eq['retrievals']}, hits taken {eq['hits']}, loop edges "
          f"{eq['loop_edges']}")
    f = p["fps"]
    phase(f"[16 retrieval] fps in clean processes (tools/make_pipe_fps.py), {f['frames']} frames, "
          f"one process each, plain then retrieval (not alternated: an order effect is not "
          f"separated): plain "
          f"{' / '.join(f'{x['fps']:.2f}' for x in f['plain'])}, global_loop_candidates=2 "
          f"{' / '.join(f'{x['fps']:.2f}' for x in f['retrieval'])} (retrievals "
          f"{[x['retrievals'] for x in f['retrieval']]}, hits "
          f"{[x['retrieval_hits'] for x in f['retrieval']]})")
    ba = p["ba"]
    phase(f"[16 ba] landmark BA on the retrieval run's graph: {ba['landmarks']} landmarks, "
          f"{ba['observations']} observations, chi2 {ba['chi2_before']:.1f} -> "
          f"{ba['chi2_after']:.1f}, {p['ba_s']:.2f} s wall; empirical covariances of "
          f"{p['cov_edges']} active edges {p['cov_ms']:.1f} ms (finite, positive diagonals); "
          f"save_graph_viz {p['viz_edges']} edges")
    h = p["host"]
    n_ret = [k for _, k in h["frames"][1:]]
    phase(f"[16 host] default_params() + global_loop_candidates=2, {len(h['frames'])} frames: "
          f"{len(h['frames']) / h['wall']:.2f} fps; synchronizing calls a frame (outside the "
          f"online optimize) {sum(len(s) for s, _ in h['frames'][1:]) / (len(n_ret) or 1):.3f}, "
          f"frames that retrieved {sum(1 for k in n_ret if k)} of {len(n_ret)} (2 syncs each, "
          f"the others 1); nodes {h['stats']['nodes']}, loop edges {h['stats']['loop_edges']}; "
          f"launches {h['launches'][:2]}; ATE L0..L4 "
          f"{' / '.join(f'{a:.4f}' for a in h['ate'])} m (limit L4 <= {h['limit']:.4f})")
    for name, o in p["odometry"].items():
        extra = (f"positions within {o['err']:.2e} m of ground truth" if name == "only" else
                 f"ATE L0..L4 {' / '.join(f'{a:.4f}' for a in o['ate'])} m (limit L4 <= "
                 f"{DEFAULT_ATE_L4_MAX:.4f})")
        phase(f"[16 odometry] default_params() + "
              f"{'use_robot_odom_only' if name == 'only' else 'use_robot_odom'}, ground truth "
              f"as odometry, {o['nodes']} nodes: {o['fps']:.2f} fps; edges {o['edges']}, of "
              f"them odometry {o['odometry_edges']}; launches {o['launches'][:2]}; {extra}")
    s = p["stereo"]
    b, by = s["front_bound"]
    phase(f"[16 stereo] synthetic --stereo {STEREO_BASELINE} ({s['synthetic_s']:.1f} s); "
          f"disparity on the card against the CPU on pairs {list(STEREO_CHECK_FRAMES)}: valid "
          f"equal on {s['valid_eq']}, disparity equal on {s['disp_eq']} of the pixels "
          f"({100 * s['valid_share']:.1f}% valid); front end a 640x480 frame: device "
          f"{fmt_ms(s['front_ms'])} (profiler, mean of 10), event span "
          f"{s['front_event_ms']:.4f} ms, {s['front_ops']} device activities; bound "
          f"{b:.4f} ms ({by})")
    phase(f"[16 stereo] rgbdslam-torch run --stereo-dir --evaluate --save-mesh, make_pipe: "
          f"ATE L0..L4 {' / '.join(f'{a:.4f}' for a in s['ate'])} m, with RANSAC seed "
          f"{OPTION_SEEDS[1]} {' / '.join(f'{a:.4f}' for a in s['ate_seed1'])} m (the mean L4 "
          f"{s['l4_mean']:.4f}, limit {s['limit']:.4f}); nodes {s['stats']['nodes']}, active "
          f"edges "
          f"{s['stats']['active_edges']}; run_stereo {s['fps']:.2f} fps "
          f"({s['run_stereo_s']:.1f} s); detect launches {s['launches'][0]}, refine "
          f"{s['launches'][1]}; synchronizing calls in {s['replay_groups']} replayed groups "
          f"{s['replay_syncs']}; whole command {s['cli_s']:.1f} s")
    phase("[16 seconds] " + ", ".join(f"{k} {v:.1f}" for k, v in p["seconds"].items()))
    phase(f"[16 mesh] mesh.ply {s['mesh_faces']} faces, {s['mesh_verts']} vertices, "
          f"{s['mesh_mib']:.1f} MiB, save_mesh {s['mesh_ms']:.0f} ms, read back "
          f"{s['mesh_read_s']:.2f} s; the CPU's mesh of the same state: faces and colours "
          f"equal, vertices within {s['mesh_vert_diff']:.2e} m")


def render_multi(device, frames: int = MULTI_FRAMES, S: int = MULTI_S) -> list:
    """Phase 17's sequences rendered on device: [(poses, rgb u8, depth u16
    TUM counts)] a sequence, world MULTI_WORLD_SEED0 + s, orbit
    MULTI_ORBIT_SEED0 + s, depth without noise
    (tools/vo_multi_jax_reference.py renders the same with the JAX
    package)."""
    import numpy as np
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld, render_sequence

    out = []
    for s in range(S):
        world = SyntheticWorld.create(seed=MULTI_WORLD_SEED0 + s, cam=TUM_DEFAULT)
        poses, rgbs, depths = render_sequence(world, frames, seed=MULTI_ORBIT_SEED0 + s,
                                              device=device)
        out.append((poses, rgbs, np.clip(depths * 5000.0 + 0.5, 0, 65535).astype(np.uint16)))
    return out


def multi_params(**over):
    """make_pipe's parameters as MultiSequenceSlam runs them: its
    pose_relative_to="inaffected" set to "first" as the UNSUPPORTED
    contract sets it (here, so that every run of the comparisons gets the
    same)."""
    return make_pipe_params(**{"pose_relative_to": "first", **over})


def multi_run(seqs, wires, frames: int, mesh=None, eager: bool = False,
              watch: bool = False, params=None) -> dict:
    """MultiSequenceSlam over the first `frames` lockstep frames of the
    encoded sequences (`wires`, a list a sequence), optimized online every
    optimizer_skip_step frames as the slam-multi CLI does: its
    trajectories, host mirrors and statistics; with watch, the
    synchronizing calls of each replayed lockstep frame, host ms a
    replayed frame (whole call with its online optimize, graph replay,
    drains, the optimize), capture seconds, the reserved MiB the capture
    frame added, peak MiB and the detect/refine/Kabsch launches of the
    run."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.graph.manager import GraphManager
    from rgbdslam_v2_tpu_torch.ops import detect, registration
    from rgbdslam_v2_tpu_torch.parallel.slam_multi import MultiSequenceSlam, _SeqManager

    S = len(seqs)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p = params or multi_params()
    ms = MultiSequenceSlam(TUM_DEFAULT, S, params=p, mesh=mesh)
    if eager:
        for sh in ms.shards:
            sh.steps = None
    gt0 = np.stack([p[0] for p, _, _ in seqs])
    out = dict(sites=[], host_ms=[], replay_ms=[], drain_ms=[], opt_ms=[], pool_mib=0.0)
    drain_s, opt_s = [0.0], [0.0]

    def timed(fn, acc):
        def run(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                acc[0] += time.perf_counter() - t0
        return run

    def state():
        return [(sh.steps.captures, sh.steps.eager_groups) for sh in ms.shards if sh.steps]

    detect.reset_launches()
    registration.reset_launches()
    alignment.reset_launches()
    with (patched(_SeqManager, "_drain_pending", timed(GraphManager._drain_pending, drain_s)),
          patched(_SeqManager, "_consume_ready_staged",
                  timed(GraphManager._consume_ready_staged, drain_s)),
          patched(MultiSequenceSlam, "optimize", timed(MultiSequenceSlam.optimize, opt_s))):
        for k in range(frames):
            def step(k=k):
                ms.add_frames(np.stack([w[k] for w in wires]), np.full(S, k / 30.0),
                              gt_poses=gt0 if k == 0 else None)
                if (k + 1) % p["optimizer_skip_step"] == 0:  # the slam-multi CLI's schedule
                    ms.optimize(iterations=p["online_optimizer_iterations"], blocking=False)
            before, rs0, d0, o0 = state(), sum(sh.steps.replay_s for sh in ms.shards
                                               if sh.steps), drain_s[0], opt_s[0]
            allocated = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            sites = sync_sites(step) if watch else step()
            dt = time.perf_counter() - t0
            after = state()
            if [c for c, _ in after] != [c for c, _ in before]:
                out["pool_mib"] += (torch.cuda.memory_allocated() - allocated) / 2**20
            if k > 0 and after == before and not eager:
                out["sites"].append(sites)
                out["host_ms"].append(1e3 * dt)
                out["replay_ms"].append(1e3 * (sum(sh.steps.replay_s for sh in ms.shards
                                                   if sh.steps) - rs0))
                out["drain_ms"].append(1e3 * (drain_s[0] - d0))
                out["opt_ms"].append(1e3 * (opt_s[0] - o0))
    out["launches"] = (detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES)
    torch.cuda.synchronize()
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["state_mib"] = ms.state_bytes() / 2**20
    out["capture_s"] = sum(sh.steps.capture_s for sh in ms.shards if sh.steps)
    out["steps"] = [(sh.steps.eager_groups, sh.steps.captures, sh.steps.replays)
                    for sh in ms.shards if sh.steps]
    ms._drain()
    out["ms"] = ms
    out["poses"] = ms.trajectories()
    out["mirrors"] = [(sq.host.edge_active.copy(), sq.host.edge_i.copy(), sq.host.edge_j.copy(),
                       list(sq.host.edge_types), list(sq.host.keyframes)) for sq in ms.seq]
    return out


def unobservable_nodes(mirrors, n: int) -> list:
    """F26 (ROADMAP Queue 3): the nodes of a dangling constant-position
    chain in a keep-all graph's host mirrors (edge_active, edge_i, edge_j,
    edge_types, ...). A run of nodes that no visual edge reaches is tied
    to the trajectory only by the constant-position fallback edges; where
    the frame after it registered visually it has no fallback edge, so
    the run hangs from one end and its poses are unconstrained (the
    reference and the JAX package build the same graph). Node 0 is the
    anchor."""
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION

    active, ei, ej, types = mirrors[:4]
    visual, const = {0}, set()
    for e, t in enumerate(types):
        if active[e]:
            pair = (int(ei[e]), int(ej[e]))
            if t == EDGE_CONST_POSITION:
                const.add((min(pair), max(pair)))
            else:
                visual.update(pair)
    out, v = [], 1
    while v < n:
        if v in visual:
            v += 1
            continue
        w = v
        while w + 1 < n and w + 1 not in visual:
            w += 1
        if not all((k, k + 1) in const for k in range(v - 1, min(w + 1, n - 1))) or w == n - 1:
            out.extend(range(v, w + 1))
        v = w + 1
    return out


def loop_graph(n: int, device, drift: float = 0.002, seed: int = 0):
    """tests/test_pose_graph.py's loop graph at n nodes on device: a circle,
    odometry edges with drift-sized noise (numpy-seeded), one exact loop
    closure, poses chained from the noisy odometry, information 100 I."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.core import se3
    from rgbdslam_v2_tpu_torch.optim.pose_graph import make_graph_state

    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    xi = np.stack([np.cos(ang), np.sin(ang), 0 * ang, 0 * ang, 0 * ang, ang], -1)
    gt = se3.exp_se3(torch.tensor(xi, dtype=torch.float32))
    rel = se3.inv(gt[:-1]) @ gt[1:]
    meas = rel @ se3.exp_se3(torch.tensor(rng.normal(0, drift, (n - 1, 6)), dtype=torch.float32))
    meas = torch.cat([meas, (se3.inv(gt[-1]) @ gt[0])[None]])
    init = [gt[0]]
    for k in range(n - 1):
        init.append(init[-1] @ meas[k])
    g = make_graph_state(n, n, device=device)
    g.poses.copy_(torch.stack(init))
    g.node_active.fill_(True)
    g.node_fixed[0] = True
    g.edge_i.copy_(torch.cat([torch.arange(n - 1), torch.tensor([n - 1])]).to(torch.int32))
    g.edge_j.copy_(torch.cat([torch.arange(1, n), torch.tensor([0])]).to(torch.int32))
    g.edge_meas.copy_(meas)
    g.edge_info.copy_(torch.eye(6).expand(n, 6, 6) * 100.0)
    g.edge_active.fill_(True)
    return g


def clean_multi_fps(seqs, wires, root: Path) -> dict:
    """Phase 17's fps in processes of their own: tools/slam_multi_fps.py on
    the encoded sequences (with the torch.profiler window), then
    tools/make_pipe_fps.py on sequence 0's frames."""
    import numpy as np

    d = root / "multi_fps"
    d.mkdir()
    T = len(wires[0])
    np.save(d / "wires.npy", np.stack([np.stack(w) for w in wires], axis=1))
    np.save(d / "stamps.npy", np.arange(T) / 30.0)
    np.save(d / "gt0.npy", np.stack([poses[0] for poses, _, _ in seqs]))
    poses, rgbs, depths = seqs[0]
    for name, arr in (("poses", poses), ("rgbs", rgbs), ("depths", depths),
                      ("stamps", np.arange(T) / 30.0)):
        np.save(d / f"{name}.npy", np.ascontiguousarray(arr))
    out = {}
    for name, tool in (("multi", "slam_multi_fps.py"), ("single", "make_pipe_fps.py")):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "tools" / tool), str(d)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"tools/{tool} exited {r.returncode}: {r.stderr[-2000:]}")
        out[name] = json.loads(r.stdout.strip().splitlines()[-1])
        out[name]["process_s"] = time.perf_counter() - t0
    shutil.rmtree(d)
    return out


def phase17(dev, tum_dirs, root: Path, frames: int = MULTI_FRAMES) -> dict:
    """ROADMAP item 28 on the card (see the module docstring, phase 17);
    fails on a gate, returns the records."""
    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.config import ParameterServer
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.eval.ate import evaluate_ate
    from rgbdslam_v2_tpu_torch.graph.compare import compare_to_candidates
    from rgbdslam_v2_tpu_torch.graph.manager import GraphManager
    from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor
    from rgbdslam_v2_tpu_torch.ops import detect, registration
    from rgbdslam_v2_tpu_torch.optim.pose_graph import lm_iteration
    from rgbdslam_v2_tpu_torch.parallel import DeviceMesh, candidate_mesh, vo_trajectories_sharded
    from rgbdslam_v2_tpu_torch.parallel.sharded import (shard_generators, sharded_compare,
                                                        sharded_lm_iteration)

    p = {"seconds": {}}
    t_all = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        p["seconds"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    S, T = MULTI_S, frames
    p["frames"] = T
    seqs = render_multi(dev, T, S)
    p["size"] = "x".join(map(str, seqs[0][1].shape[2:0:-1]))
    stamps = list(np.arange(T) / 30.0)
    gt_xyz = [poses[:, :3, 3] for poses, _, _ in seqs]
    ms0 = GraphManager(TUM_DEFAULT, multi_params(tpu_max_nodes=2, tpu_max_edges=32), device=dev)
    t_enc = time.perf_counter()
    wires = [[ms0.encode(r, d) for r, d in zip(rgbs, depths)] for _, rgbs, depths in seqs]
    p["encode_ms"] = 1e3 * (time.perf_counter() - t_enc) / T  # S encodes a lockstep frame
    del ms0
    lap("render and encode")

    # ---- the main run: 8 sequences, make_pipe, the CLI's online optimizes
    run = multi_run(seqs, wires, T, watch=True)
    p["launches"] = run["launches"]
    if run["launches"][:2] != (S * T, S * (T - 1)) or run["launches"][2] != 0:
        fail(f"[17 multi] launches (detect, refine, Kabsch) {run['launches']}, expected "
             f"({S * T}, {S * (T - 1)}, 0)")
    bad = [s for s in run["sites"] if s]
    p["replayed"], p["steps"] = len(run["sites"]), (run["steps"] or [(0, 0, 0)])[0]
    eager, captures, replays = p["steps"]
    # the key runs eagerly once, then is captured (and replayed) on its next
    # frame and replayed after: the FAST threshold stays fixed (F25)
    if bad or eager != captures or eager + replays != T - 1:
        fail(f"[17 multi] replayed lockstep frames synchronized {bad[:3]} (eager, captured, "
             f"replayed {run['steps']})")
    for key in ("host_ms", "replay_ms", "drain_ms"):
        p[key] = statistics.median(run[key])
    p["host_mean_ms"] = statistics.mean(run["host_ms"])
    opt = [x for x in run["opt_ms"] if x > 0]  # the lockstep frames with online optimizes
    p["opt_ms"] = (statistics.mean(run["opt_ms"]), statistics.mean(opt) if opt else 0.0, len(opt))
    p.update(peak_mib=run["peak_mib"], state_mib=run["state_mib"], capture_s=run["capture_s"],
             pool_mib=run["pool_mib"], stats=run["ms"].statistics())
    mirrors_main = run["mirrors"]  # read before the protocol prunes
    levels, ate = run["ms"].evaluation_protocol(gt_stamps=[stamps] * S, gt_xyz=gt_xyz)
    ate = p["ate"] = {lv: [float(x) for x in v] for lv, v in ate.items()}
    # the gate's L4: over the frames a visual edge constrains (F26's
    # dangling chains left out, and counted)
    p["f26"], p["l4_gate"] = {}, []
    for i in range(S):
        hang = unobservable_nodes(mirrors_main[i], T)
        keep = np.setdiff1d(np.arange(T), hang)
        if hang:
            p["f26"][i] = hang
        p["l4_gate"].append(float(evaluate_ate(np.asarray(stamps)[keep], levels[4][i, keep, :3, 3],
                                               stamps, gt_xyz[i]).rmse))
    if not all(np.isfinite(x) and x <= MULTI_L4_MAX for x in p["l4_gate"]):
        fail(f"[17 multi] L4 over the constrained frames {p['l4_gate']} (limit {MULTI_L4_MAX} m "
             f"each; all frames {ate[4]}, dangling chains {p['f26']})")
    lap("multi run")

    # ---- sharded compare on the main run's store: 2 shards on one card --
    sq = run["ms"].seq[0]
    kp, depth_small, _ = sq._extract(sq._to_device(wires[0][T // 2]))
    h = T // 2  # its 4 predecessors and 4 earlier nodes
    cand = torch.tensor([h - 1, h - 2, h - 3, h - 4, *np.linspace(0, h - 5, 4).astype(int)],
                        device=dev)
    mesh2 = DeviceMesh((dev, dev))
    kw = dict(cam_fx=TUM_DEFAULT.fx, cam_fy=TUM_DEFAULT.fy, cam_cx=TUM_DEFAULT.cx,
              cam_cy=TUM_DEFAULT.cy, **sq._compare_kwargs())
    gen = torch.Generator(device=dev).manual_seed(5)
    ref_gen = torch.Generator(device=dev)
    ref_gen.set_state(gen.get_state())
    got = sharded_compare(mesh2, kp, depth_small, sq.store, cand, gen, sq.cam_small, **kw)
    parts = [compare_to_candidates(kp, depth_small, sq.store, cand[lo:hi], g, sq.cam_small, **kw)
             for (_, lo, hi), g in zip(mesh2.blocks(8), shard_generators(ref_gen, mesh2.devices))]
    diff = [k for k, v in got._asdict().items()
            if v is not None and not torch.equal(v, torch.cat([getattr(x, k) for x in parts]))]
    if diff:
        fail(f"[17 sharded] sharded_compare differs from the per-shard calls in {diff}")
    p["compare_ok"] = int(got.ransac_ok.sum())
    del run, sq, kp, got, parts
    lap("sharded compare")

    # ---- sequences 0 and 7 alone: MultiSequenceSlam with S = 1 ----------
    p["single"] = {}
    for i in MULTI_SINGLE:
        one = multi_run([seqs[i]], [wires[i]], T, params=multi_params(tpu_seed=i))
        h = one["ms"].seq[0].host
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(one["mirrors"][0], mirrors_main[i]))
        _, single = one["ms"].evaluation_protocol(gt_stamps=[stamps], gt_xyz=[gt_xyz[i]])
        d = {lv: abs(float(single[lv][0]) - ate[lv][i]) for lv in (0, 4)}
        p["single"][i] = dict(same=same, l0=float(single[0][0]), l4=float(single[4][0]),
                              d0=d[0], d4=d[4], edges=h.n_edges, keyframes=len(h.keyframes))
        del one, h
        if not same or max(d.values()) > MULTI_SINGLE_TOL:
            fail(f"[17 single] sequence {i} against MultiSequenceSlam(S=1, tpu_seed={i}): "
                 f"mirrors equal {same}, |L0 - L0'| {d[0]:.3e}, |L4 - L4'| {d[4]:.3e} (limit "
                 f"{MULTI_SINGLE_TOL} m)")
    lap("sequences alone")

    # ---- replay = eager and mesh = no mesh, no online optimize ----------
    n_eq = min(MULTI_EQUAL_FRAMES, T)
    eq = multi_params(optimizer_skip_step=10**6)
    graph_run = multi_run(seqs, wires, n_eq, params=eq)
    mirrors_graph, poses_graph = graph_run["mirrors"], graph_run["poses"]
    del graph_run
    eager_run = multi_run(seqs, wires, n_eq, eager=True, params=eq)
    p["replay_vs_eager"] = float(np.abs(eager_run["poses"] - poses_graph).max())
    if not (np.array_equal(eager_run["poses"], poses_graph) and all(
            all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(x, y))
            for x, y in zip(eager_run["mirrors"], mirrors_graph))):
        fail(f"[17 equal] replayed lockstep frames differ from eager ones: max pose "
             f"difference {p['replay_vs_eager']:.3e}")
    del eager_run
    mesh_run = multi_run(seqs, wires, n_eq, mesh=mesh2, params=eq)
    p["mesh_steps"] = mesh_run["steps"]
    p["mesh_vs_none"] = float(np.abs(mesh_run["poses"] - poses_graph).max())
    if not (np.array_equal(mesh_run["poses"], poses_graph) and all(
            all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(x, y))
            for x, y in zip(mesh_run["mirrors"], mirrors_graph))):
        fail(f"[17 equal] the 2-shard mesh differs from mesh=None: max pose difference "
             f"{p['mesh_vs_none']:.3e}")
    del mesh_run
    gc.collect()
    torch.cuda.empty_cache()
    lap("replay = eager, mesh = no mesh")

    # ---- sharded LM on a 1024-node graph --------------------------------
    g = loop_graph(1024, dev)
    lam = torch.tensor(1e-4, device=dev)
    p1, _, cb1, ca1 = lm_iteration(g, lam, 1.0, 32, solver="pcg")
    p2, _, cb2, ca2 = sharded_lm_iteration(mesh2, g, lam, 1.0, 32)
    p["lm"] = dict(chi2_before=(float(cb1), float(cb2)), chi2_after=(float(ca1), float(ca2)),
                   pose_diff=float((p1 - p2).abs().max()))
    lm = p["lm"]
    if not (abs(lm["chi2_before"][0] - lm["chi2_before"][1]) < 1e-2 * max(lm["chi2_before"][0], 1)
            and abs(lm["chi2_after"][0] - lm["chi2_after"][1]) < 5e-2 * max(lm["chi2_after"][0], 1)
            and lm["pose_diff"] < 1e-3):
        fail(f"[17 sharded] sharded_lm_iteration against lm_iteration: {lm}")
    del g, p1, p2
    lap("sharded LM")

    # ---- vo-multi: the same 8 sequences ----------------------------------
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    grays = [(rgbs.astype(np.float32) @ luma) / 255.0 for _, rgbs, _ in seqs]
    dm = [d.astype(np.float32) / 5000.0 for _, _, d in seqs]
    vkw = dict(VO_MULTI)
    ext = OrbExtractor(max_keypoints=vkw.pop("max_keypoints"))
    seed = vkw.pop("seed")
    detect.reset_launches()
    registration.reset_launches()
    alignment.reset_launches()
    torch.cuda.synchronize()
    tv = time.perf_counter()
    res = vo_trajectories_sharded(candidate_mesh(), grays, dm, seed, ext, TUM_DEFAULT, **vkw)
    est = res.poses.cpu().numpy()
    p["vo_s"] = time.perf_counter() - tv
    p["vo_launches"] = (detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES)
    p["vo_l0"] = [float(evaluate_ate(stamps, est[s, :, :3, 3], stamps, gt_xyz[s]).rmse)
                  for s in range(S)]
    p["vo_ok"] = float(res.ok.float().mean())
    del grays, dm, res
    if p["vo_launches"] != (S * T, S * (T - 1), 0):
        fail(f"[17 vo] launches (detect, refine, Kabsch) {p['vo_launches']}")
    if VO_MULTI_L0_JAX is not None and T == MULTI_FRAMES:
        lim = [max(1.5 * j, j + 0.005) for j in VO_MULTI_L0_JAX]
        if not all(a <= b for a, b in zip(p["vo_l0"], lim)):
            fail(f"[17 vo] L0 {p['vo_l0']} against the limits {lim}")
    lap("vo-multi")

    # ---- no fallback to the CPU; the CLI on phase 12's TUM directories ---
    n_cards = torch.cuda.device_count()
    try:
        GraphManager(TUM_DEFAULT, ParameterServer({"tpu_mesh_devices": n_cards + 1}))
        fail(f"[17 mesh] GraphManager with tpu_mesh_devices={n_cards + 1} built")
    except ValueError as exc:
        p["mesh_refusal"] = str(exc)
        if f"requested {n_cards + 1} devices, have {n_cards}" not in str(exc):
            fail(f"[17 mesh] refusal reads {exc}")
    out = root / "slam_multi"
    code, stdout, _ = run_cli(["slam-multi", *tum_dirs, "--devices", "auto", "--out", out,
                               "--max-frames", T, *make_pipe_flags()])
    if code != 0 or not (out / "slam_multi_report.json").is_file():
        fail(f"[17 cli] rgbdslam-torch slam-multi exited {code}")
    rep = json.loads((out / "slam_multi_report.json").read_text())
    p["cli"] = dict(devices=rep["devices"], frames=rep["frames"],
                    l4=[e["ate_rmse"]["4"] for e in rep["sequences"].values()],
                    files=len(list(out.glob("seq*_estimate_iteration_*.txt"))))
    if rep["devices"] != n_cards or p["cli"]["files"] != 5 * len(tum_dirs):
        fail(f"[17 cli] report {p['cli']}")
    lap("refusal and CLI")

    p["fps"] = clean_multi_fps(seqs, wires, root)
    lap("clean-process fps")
    p["total_s"] = time.perf_counter() - t_all
    return p


def report_phase17(p: dict, smi_line: str) -> None:
    """Phase 17's lines."""
    S, T = MULTI_S, p["frames"]
    ate, st = p["ate"], p["stats"]
    phase(f"[17 multi] MultiSequenceSlam: {S} sequences x {T} lockstep frames of {p['size']}, "
          f"make_pipe (pose_relative_to first; optimized every optimizer_skip_step frames as the "
          f"slam-multi CLI does), one world each; protocol L0 "
          f"{' / '.join(f'{x:.4f}' for x in ate[0])} m; L4 "
          f"{' / '.join(f'{x:.4f}' for x in ate[4])} m (all frames); active edges "
          f"{' / '.join(str(s['active_edges']) for s in st)}, loop edges "
          f"{' / '.join(str(s['loop_edges']) for s in st)}, keyframes "
          f"{' / '.join(str(s['keyframes']) for s in st)}")
    phase(f"[17 multi] L4 over the frames a visual edge constrains "
          f"{' / '.join(f'{x:.4f}' for x in p['l4_gate'])} m (limit {MULTI_L4_MAX} each); "
          f"dangling constant-position "
          f"chains (F26; excluded there): "
          + ("; ".join(f"sequence {i}: nodes {v[0]}-{v[-1]} ({len(v)})"
                       for i, v in p["f26"].items()) or "none"))
    phase(f"[17 multi] launches: detect {p['launches'][0]} (= {S} x {T}), refine "
          f"{p['launches'][1]} (= {S} x {T - 1}), Kabsch {p['launches'][2]}; the lockstep step "
          f"(one CUDA graph of {S} step bodies a key): {p['steps'][0]} eager frames, "
          f"{p['steps'][1]} captures, {p['steps'][2]} replays; synchronizing calls in the "
          f"{p['replayed']} replayed lockstep frames: 0; capture "
          f"{p['capture_s']:.3f} s, graph pools {p['pool_mib']:.1f} MiB (memory the capture "
          f"frames left allocated); state {p['state_mib'] / S:.1f} MiB a sequence, peak "
          f"{p['peak_mib'] / S:.1f} MiB a sequence ({p['peak_mib']:.1f} MiB in all) [{smi_line}]")
    om = p["opt_ms"]
    phase(f"[17 multi] host ms a replayed lockstep frame: add_frames median {p['host_ms']:.3f} "
          f"(graph replay {p['replay_ms']:.3f}, drains {p['drain_ms']:.3f}, the rest slot "
          f"selection, packing and copies), mean {p['host_mean_ms']:.3f}, of which the online "
          f"optimizes {om[0]:.3f} ({om[2]} lockstep frames with {S} of them, {om[1]:.3f} ms "
          f"each such frame); encode of the {S} wires {p['encode_ms']:.3f} ms a lockstep frame "
          f"(before the run) [{smi_line}]")
    for i, s in p["single"].items():
        phase(f"[17 single] sequence {i} against MultiSequenceSlam(S=1, tpu_seed={i}) fed the "
              f"same wires: edge mirrors, edge types and keyframes equal {s['same']} "
              f"({s['edges']} edge slots, {s['keyframes']} keyframes); L0 {s['l0']:.6f} against "
              f"{ate[0][i]:.6f} m (|d| {s['d0']:.2e}), L4 {s['l4']:.6f} against "
              f"{ate[4][i]:.6f} m (|d| {s['d4']:.2e}; limit {MULTI_SINGLE_TOL})")
    phase(f"[17 equal] {min(MULTI_EQUAL_FRAMES, T)} lockstep frames without online optimize: "
          f"replayed = eager steps, max pose difference {p['replay_vs_eager']:.1e} (bitwise, "
          f"edge mirrors equal); a 2-shard mesh (cuda:0, cuda:0) = mesh=None "
          f"{p['mesh_vs_none']:.1e} (bitwise; each shard: eager, captured, replays "
          f"{p['mesh_steps']})")
    lm = p["lm"]
    phase(f"[17 sharded] sharded_compare over the 2-shard mesh = the per-shard "
          f"compare_to_candidates calls concatenated (bitwise; {p['compare_ok']} of 8 "
          f"candidates registered); sharded_lm_iteration on a 1024-node loop graph against "
          f"lm_iteration (PCG, 32 iterations): chi2 before {lm['chi2_before'][1]:.4f} / "
          f"{lm['chi2_before'][0]:.4f}, after {lm['chi2_after'][1]:.4f} / "
          f"{lm['chi2_after'][0]:.4f}, max pose difference {lm['pose_diff']:.2e} (JAX's "
          f"tolerances: 1e-2, 5e-2 relative, 1e-3)")
    jax_l0 = VO_MULTI_L0_JAX if T == MULTI_FRAMES else None
    phase(f"[17 vo] vo_trajectories_sharded on the {S} sequences ({T} frames, ORB-600, RANSAC "
          f"200): L0 {' / '.join(f'{x:.4f}' for x in p['vo_l0'])} m"
          + ("" if jax_l0 is None else
             f" against the JAX package's {' / '.join(f'{x:.4f}' for x in jax_l0)} m (limit "
             f"max(1.5 x, + 5 mm))")
          + f"; RANSAC success {p['vo_ok']:.3f}; launches detect {p['vo_launches'][0]}, "
          f"refine {p['vo_launches'][1]}, Kabsch {p['vo_launches'][2]}; {p['vo_s']:.2f} s "
          f"[{smi_line}]")
    cli = p["cli"]
    phase(f"[17 cli] GraphManager with tpu_mesh_devices above the cards: ValueError "
          f"\"{p['mesh_refusal']}\"; rgbdslam-torch slam-multi --devices auto on phase 12's "
          f"two TUM directories, {cli['frames']} frames, make_pipe: {cli['devices']} device, "
          f"{cli['files']} trajectory files and slam_multi_report.json, L4 "
          f"{' / '.join(f'{x:.4f}' for x in cli['l4'])} m")
    m, s1 = p["fps"]["multi"], p["fps"]["single"]
    phase(f"[17 fps] clean processes (tools/slam_multi_fps.py), {T} frames, {WARMUP} warm-up: "
          f"slam-multi {m['sequence_frames_per_s']:.2f} sequence-frames/s "
          f"({m['lockstep_fps']:.2f} lockstep frames/s, wires encoded ahead, "
          f"{m['frames_timed']} timed) against {S} x make_pipe's {s1['fps']:.2f} fps on "
          f"sequence 0 (tools/make_pipe_fps.py, {s1['frames']} timed) = {S * s1['fps']:.2f}; "
          f"profiler window of {m['profile_frames']} "
          f"lockstep frames: device busy {m['device_ms'] or float('nan'):.3f} ms a lockstep "
          f"frame, {100 * (m['busy_share'] or float('nan')):.1f}% of wall "
          f"({m['wall_ms']:.3f} ms), {m['device_ops']:.0f} device activities; processes "
          f"{m['process_s']:.1f} / {s1['process_s']:.1f} s [{smi_line}]")
    phase(f"[17 seconds] " + ", ".join(f"{k} {v:.1f}" for k, v in p["seconds"].items())
          + f"; phase {p['total_s']:.1f} s")


SERVE_FRAMES = 120  # phase 18: frames of each run --serve
SERVE_INTERVAL = 30  # --serve-interval (the CLI's default)
# phase 18's control sequence over HTTP, by the frames offered so far (group
# boundaries of make_pipe's 4 frames a step after the single first frame)
SERVE_SAVE_AT, SERVE_PAUSE_AT, SERVE_STEP_AT, SERVE_RESUME_AT, SERVE_PARAM_AT = 21, 41, 51, 52, 60
SERVE_SCRIPT = {SERVE_SAVE_AT: "save", SERVE_PAUSE_AT: "pause", SERVE_STEP_AT: "step",
                SERVE_RESUME_AT: "pause",
                SERVE_PARAM_AT: "param?name=observability_threshold&value=1.0"}
SERVE_DROPPED = range(SERVE_PAUSE_AT, SERVE_STEP_AT)  # offered while paused, dropped
SERVE_POSE_TOL = 1e-5  # metres: the controlled runs' poses, captured against eager (atomics)
SERVE_FPS_RUNS = 2  # run_tum with the live view on and off, alternating, each


def serve_run(tum_dir: Path, out: Path, eager: bool) -> dict:
    """rgbdslam-torch run --tum-dir --serve 0 with make_pipe's parameters on
    SERVE_FRAMES frames, in this process, driven over HTTP from a thread of
    its own: after the frames SERVE_SCRIPT names have been offered, the run
    loop waits while that thread POSTs the action to /ctl/ (so each lands at
    a fixed frame); during the CLI's final linger it GETs the page and the
    panes. eager: the steps run without CUDA graphs. Records launches and
    pipeline counters around each action, the synchronizing calls of each
    group that only replayed, the step graphs' counts and the host mirrors."""
    import io
    import socketserver
    import types
    import urllib.error
    import urllib.request

    import torch
    import rgbdslam_v2_tpu_torch.pipeline as pipeline_pkg
    from rgbdslam_v2_tpu_torch.apps import cli
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.ops import detect, registration

    rec = {"actions": {}, "at": {}, "replay_sites": [], "page": None}
    server, built = {}, []
    http = ThreadPoolExecutor(1, thread_name_prefix="http-client")

    def request(path, post=False):
        url = f"http://127.0.0.1:{server['srv'].server_address[1]}{path}"
        req = urllib.request.Request(url, method="POST" if post else "GET")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, b""

    class Recording(socketserver.TCPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            server["srv"] = self

    def snapshot(pipe):
        sg = pipe.manager.step_graph
        return dict(detect=detect.LAUNCHES, refine=registration.LAUNCHES,
                    processed=pipe.n_processed, dropped=pipe.n_dropped,
                    nodes=pipe.manager.n_nodes, paused=pipe.paused,
                    keys=sg and (sg.eager_groups, sg.captures))

    class Controlled(pipeline_pkg.SlamPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if eager:
                self.manager.step_graph = None
            self.offered = 0
            built.append(self)

        def _after(self, n):
            self.offered += n
            action = SERVE_SCRIPT.get(self.offered)
            rec["at"][self.offered] = snapshot(self)
            if action is not None:
                code, body = http.submit(request, f"/ctl/{action}", True).result()
                rec["actions"][self.offered] = (self.offered, code, json.loads(body))

        def process_frame(self, *a, **kw):
            took = super().process_frame(*a, **kw)
            self._after(1)
            return took

        def _process_group(self, compacts, stamps):
            sg = self.manager.step_graph
            state = sg and (sg.captures, sg.eager_groups)
            sites = sync_sites(lambda: super(Controlled, self)._process_group(compacts, stamps))
            if sg and (sg.captures, sg.eager_groups) == state:
                rec["replay_sites"].append((self.offered, sites))
            self._after(len(compacts))

    def linger(seconds):  # the CLI's wait for the page's last poll
        pipe = built[0]
        rec["linger_s"] = seconds
        rec["page"] = http.submit(request, "/").result()
        rec["gen"] = http.submit(request, "/gen").result()
        rec["panes"] = [http.submit(request, f"/{n}?g=1").result() for n in
                        ("frame.png", "depth.png")]
        rec["save_pending"] = pipe._live_save_requested

    detect.reset_launches()
    registration.reset_launches()
    alignment.reset_launches()
    argv = ["run", "--tum-dir", tum_dir, "--out", out, "--max-frames", SERVE_FRAMES,
            "--serve", 0, "--serve-interval", SERVE_INTERVAL, *make_pipe_flags()]
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with (patched(pipeline_pkg, "SlamPipeline", Controlled),
              patched(socketserver, "TCPServer", Recording),
              patched(cli, "time", types.SimpleNamespace(sleep=linger)),
              contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err)):
            code = cli.main([str(a) for a in argv])
    finally:
        http.shutdown(wait=True)
    rec["cli_s"] = time.perf_counter() - t0
    if code != 0 or not built:
        print(err.getvalue()[-4000:], file=sys.stderr, end="")
        fail(f"[18 serve] rgbdslam-torch run --serve exited {code}")
    pipe = built[0]
    mgr = pipe.manager
    sg = mgr.step_graph
    rec["url"] = json.loads(err.getvalue().strip().splitlines()[-1])["url"]
    rec["launches"] = (detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES)
    rec["steps"] = sg and (sg.eager_groups, sg.captures, sg.replays, sg.capture_s)
    mgr._drain_pending()
    h = mgr.host
    rec["mirrors"] = (h.edge_active.copy(), h.edge_i.copy(), h.edge_j.copy(), list(h.edge_types))
    rec["poses"] = mgr.poses()
    rec["final"] = snapshot(pipe)
    rec["final"].pop("keys")
    rec["pipe"] = pipe
    torch.cuda.synchronize()
    return rec


def phase18(dev, tum_dir: Path, root: Path) -> dict:
    """ROADMAP item 27b on the card (see the module docstring, phase 18);
    fails on a gate, returns the records."""
    import io
    import socketserver
    import urllib.request

    import numpy as np
    import torch
    from rgbdslam_v2_tpu_torch.apps import cli
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.graph.g2o_io import read_g2o
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION
    from rgbdslam_v2_tpu_torch.io import TumDataset
    from rgbdslam_v2_tpu_torch.io.png import read_png
    from rgbdslam_v2_tpu_torch.io.pointcloud import read_pcd
    from rgbdslam_v2_tpu_torch.io.tum import read_trajectory_file
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline
    from rgbdslam_v2_tpu_torch.utils import roofline

    p = {"seconds": {}}
    t_all = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        p["seconds"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    out, out_e = root / "serve", root / "serve_eager"
    run = serve_run(tum_dir, out, eager=False)
    lap("run --serve")
    at, act = run["at"], run["actions"]
    # pause: the frames offered while paused are dropped and launch nothing
    first, last = at[SERVE_DROPPED[0]], at[SERVE_DROPPED[-1] + 1]
    p["pause"] = dict(act=act[SERVE_PAUSE_AT], dropped=len(SERVE_DROPPED),
                      launches=(last["detect"] - first["detect"], last["refine"] - first["refine"]),
                      moved=(last["processed"] - first["processed"],
                             last["nodes"] - first["nodes"]))
    if (act[SERVE_PAUSE_AT][2] != {"status": "paused"} or p["pause"]["launches"] != (0, 0)
            or p["pause"]["moved"] != (0, 0) or act[SERVE_RESUME_AT][2] != {"status": "running"}):
        fail(f"[18 serve] while paused: {p['pause']}")
    # step: exactly one frame, one detect and one refine launch
    a, b = at[SERVE_STEP_AT], at[SERVE_RESUME_AT]
    p["step"] = dict(act=act[SERVE_STEP_AT], moved=(b["processed"] - a["processed"],
                                             b["nodes"] - a["nodes"]),
                     launches=(b["detect"] - a["detect"], b["refine"] - a["refine"]))
    if p["step"]["moved"] != (1, 1) or p["step"]["launches"] != (1, 1) or not b["paused"]:
        fail(f"[18 serve] /ctl/step: {p['step']}, paused after it {b['paused']}")
    # param: a new key (eager, then one capture), every later frame rejected
    active, ei, ej, types = run["mirrors"]
    eg, caps, reps, cap_s = run["steps"]
    new_keys = (eg - at[SERVE_PARAM_AT]["keys"][0], caps - at[SERVE_PARAM_AT]["keys"][1])
    first_after, n = at[SERVE_PARAM_AT]["nodes"], run["final"]["nodes"]  # the node ids after it
    bad = [nid for nid in range(first_after, n)
           if [types[e] for e in np.nonzero(active)[0] if ej[e] == nid] != [EDGE_CONST_POSITION]]
    visual_before = sum(types[e] != EDGE_CONST_POSITION for e in np.nonzero(active)[0]
                        if ej[e] < first_after)
    after = [sites for at_k, sites in run["replay_sites"] if at_k >= SERVE_PARAM_AT]
    p["param"] = dict(act=act[SERVE_PARAM_AT], rejected=n - first_after - len(bad),
                      later=n - first_after,
                      visual_before=visual_before, eager_groups=eg, captures=caps, replays=reps,
                      capture_s=cap_s, new_keys=new_keys, replayed_after=len(after),
                      syncs_after=sum(len(s) for s in after), launches=run["launches"])
    # after the change: one new key, run eagerly once and captured once
    if (act[SERVE_PARAM_AT][2] != {"status": "observability_threshold=1.0"} or bad
            or not visual_before or new_keys != (1, 1) or not after
            or p["param"]["syncs_after"]):
        fail(f"[18 serve] /ctl/param: {p['param']}, nodes not entering by their "
             f"constant-position edge alone {bad[:5]}")
    # the same run stepped eagerly, with the same controls at the same frames
    eager = serve_run(tum_dir, out_e, eager=True)
    lap("run --serve, eager")
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(run["mirrors"], eager["mirrors"]))
    p["eager"] = dict(same=same, pose_diff=float(np.abs(run["poses"] - eager["poses"]).max()),
                      final=run["final"] == eager["final"])
    if not same or not p["eager"]["pose_diff"] <= SERVE_POSE_TOL or not p["eager"]["final"]:
        fail(f"[18 serve] captured against eager: {p['eager']}")
    # outputs: the live files parse, the cloud the save asked for, the page
    ds = TumDataset.open(tum_dir)
    shape = ds.load(0)[1].shape
    est = read_trajectory_file(out / "estimate.txt")
    g_poses, _fixed, g_edges = read_g2o(out / "graph.g2o")
    pts, _ = read_pcd(out / "cloud.pcd")
    panes = [read_png(out / f) for f in ("frame.png", "depth.png")]
    status, page = run["page"]
    p["outputs"] = dict(estimate=est.shape[0], g2o=(len(g_poses), len(g_edges)),
                        cloud=len(pts), panes=[x.shape for x in panes], page=len(page),
                        save=act[SERVE_SAVE_AT], url=run["url"], gen=int(run["gen"][1]),
                        served_panes=[c for c, _ in run["panes"]], linger_s=run["linger_s"])
    if (est.shape[0] != n or len(g_poses) != n or not len(g_edges) or not len(pts)
            or any(x.shape != shape for x in panes) or status != 200
            or b"bPause" not in page or b"const DATA" not in page
            or p["outputs"]["served_panes"] != [200, 200] or run["save_pending"]):
        fail(f"[18 serve] live outputs: {p['outputs']}")
    # view --html --views 2, then serve answering GET /
    code, stdout, _ = run_cli(["view", out, "--html", "--views", 2])
    views = json.loads(stdout.strip().splitlines()[-1]) if code == 0 else {}
    p["view"] = dict(code=code, views=len(views.get("views", [])),
                     html=Path(views.get("html", "/nonexistent")).is_file())
    if p["view"] != dict(code=0, views=2, html=True) or not all(
            read_png(v).shape == (720, 960, 3) for v in views["views"]):
        fail(f"[18 view] {p['view']}")
    with socketserver.TCPServer(("127.0.0.1", 0), lambda *a: None) as probe:
        port = probe.server_address[1]
    serve = subprocess.Popen([sys.executable, "-m", "rgbdslam_v2_tpu_torch.apps.cli", "serve",
                              str(out), "--port", str(port)], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        body, t_s = None, time.perf_counter()
        while body is None and time.perf_counter() - t_s < 60 and serve.poll() is None:
            try:
                body = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
            except OSError:
                time.sleep(0.2)
        p["serve"] = dict(answered=body is not None and b"const DATA" in body,
                          s=time.perf_counter() - t_s)
    finally:
        serve.terminate()
        serve.wait(30)
    if not p["serve"]["answered"]:
        fail(f"[18 serve] rgbdslam-torch serve did not answer GET /: "
             f"{serve.stderr.read().decode()[-2000:]}")
    lap("outputs, view, serve")
    # fps: run_tum with the live view on (live_dir, a server, no requests)
    # and off, alternating, at equal frame counts
    p["fps"] = {"on": [], "off": []}
    p["live"] = []  # each on-run's refreshes: (count, read ms, write ms) a refresh
    p["fps"]["warm-up"] = []
    for kind in ("warm-up",) + ("on", "off") * SERVE_FPS_RUNS:
        pipe = SlamPipeline(TUM_DEFAULT, make_pipe_params(), device=dev)
        httpd = None
        if kind != "off":
            pipe.live_dir, pipe.live_interval = root / "fps_live", SERVE_INTERVAL
            httpd = socketserver.TCPServer(("127.0.0.1", 0),
                                           cli.make_viewer_handler(pipe.live_dir, pipe=pipe))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
        torch.cuda.synchronize()
        tf = time.perf_counter()
        pipe.run_tum(ds, SERVE_FRAMES)
        pipe.wait_live()  # the last refresh's files written
        torch.cuda.synchronize()
        p["fps"][kind].append(SERVE_FRAMES / (time.perf_counter() - tf))
        if kind == "on":
            lt = pipe.live_times
            n = max(1, lt["refreshes"])
            p["live"].append((lt["refreshes"], 1e3 * lt["read_s"] / n, 1e3 * lt["write_s"] / n))
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        del pipe
    lap("fps on and off")
    _, rgb, depth = ds.load(SERVE_PARAM_AT)
    buf = io.StringIO()
    rows = roofline.report(run["pipe"].manager, rgb, depth, n_steps=10, out=buf,
                           tag="[18 roofline]")
    p["roofline"] = buf.getvalue().rstrip("\n").splitlines()
    p["roofline_rows"] = rows
    if any(r[1] is None for r in rows):
        fail("[18 roofline] a stage's traces held no device activity")
    del run, eager
    gc.collect()
    torch.cuda.empty_cache()
    lap("roofline")
    p["total_s"] = time.perf_counter() - t_all
    return p


def report_phase18(p: dict, smi_line: str) -> None:
    """Phase 18's lines."""
    pa, st, pr, o = p["pause"], p["step"], p["param"], p["outputs"]
    phase(f"[18 serve] rgbdslam-torch run --tum-dir --serve 0 --serve-interval {SERVE_INTERVAL}, "
          f"make_pipe, {SERVE_FRAMES} frames of 640x480, driven over HTTP at fixed frames: "
          f"/ctl/pause at {pa['act'][0]} {pa['act'][2]}: {pa['dropped']} frames dropped with "
          f"(detect, refine) launches {pa['launches']} and (processed, nodes) moved "
          f"{pa['moved']}; /ctl/step at {st['act'][0]}: (processed, nodes) +{st['moved']}, "
          f"launches +{st['launches']}; /ctl/save at {o['save'][0]} {o['save'][2]}")
    phase(f"[18 serve] /ctl/param at {pr['act'][0]} {pr['act'][2]}: {pr['rejected']} of the "
          f"{pr['later']} nodes after it enter by their constant-position edge "
          f"alone ({pr['visual_before']} visual edges before); step graphs: {pr['eager_groups']} "
          f"eager groups, {pr['captures']} captures ({pr['new_keys'][1]} re-capture after the "
          f"change; {pr['capture_s']:.3f} s capturing in all), {pr['replays']} replays; "
          f"launches detect {pr['launches'][0]}, refine {pr['launches'][1]}, Kabsch "
          f"{pr['launches'][2]}; "
          f"synchronizing calls in the {pr['replayed_after']} replayed groups after it "
          f"{pr['syncs_after']}; the same run stepped eagerly: edge mirrors equal "
          f"{p['eager']['same']}, max pose difference {p['eager']['pose_diff']:.2e} (limit "
          f"{SERVE_POSE_TOL}; the online optimizes' float atomics) [{smi_line}]")
    phase(f"[18 serve] live outputs parse: estimate.txt {o['estimate']} rows, graph.g2o "
          f"{o['g2o'][0]} vertices / {o['g2o'][1]} edges, cloud.pcd {o['cloud']} points, "
          f"frame.png and depth.png {o['panes'][0]}; served {o['url']} (page {o['page']} "
          f"bytes with the controls, gen {o['gen']}, panes {o['served_panes']}) during the "
          f"{o['linger_s']} s linger; view --html --views 2: {p['view']['views']} PNGs and the "
          f"page; serve answered GET / after {p['serve']['s']:.2f} s")
    f = p["fps"]
    phase(f"[18 fps] run_tum, make_pipe, {SERVE_FRAMES} frames, alternating: live view on "
          f"(live_dir every {SERVE_INTERVAL} frames, a server up) "
          f"{' / '.join(f'{x:.2f}' for x in f['on'])} fps, off "
          f"{' / '.join(f'{x:.2f}' for x in f['off'])} fps, after a warm-up run with it on "
          f"({f['warm-up'][0]:.2f} fps, not counted) [{smi_line}]")
    phase("[18 live] a refresh, each on-run: " + "; ".join(
        f"{n} refreshes, {r:.2f} ms reading the card on the run loop, {w:.2f} ms writing "
        f"the files on the worker" for n, r, w in p["live"]))
    for line in p["roofline"]:
        phase(line)
    phase(f"[18 seconds] " + ", ".join(f"{k} {v:.1f}" for k, v in p["seconds"].items())
          + f"; phase {p['total_s']:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=520)
    args = ap.parse_args()
    if args.frames < SERVE_FRAMES:
        fail(f"--frames must be at least {SERVE_FRAMES} (phase 18's control sequence)")
    n_main, n_default = min(MAIN_FRAMES, args.frames), min(DEFAULT_FRAMES, args.frames)
    n_spin, n_hard = min(SPIN_FRAMES, args.frames), min(HARD_FRAMES, args.frames)
    n_dicp = min(DEFAULT_ICP_FRAMES, args.frames)

    if not (ROOT / "rgbdslam_v2_tpu_torch" / "csrc" / "detect_corners.cu").is_file():
        fail(f"the port package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from rgbdslam_v2_tpu_torch import backend
    from rgbdslam_v2_tpu_torch.config import ParameterServer, default_params
    from rgbdslam_v2_tpu_torch.core import alignment
    from rgbdslam_v2_tpu_torch.core.camera import TUM_DEFAULT
    from rgbdslam_v2_tpu_torch.graph import ingest
    from rgbdslam_v2_tpu_torch.graph.host_graph import EDGE_CONST_POSITION
    from rgbdslam_v2_tpu_torch.io import SyntheticWorld, native_compact, render_sequence
    from rgbdslam_v2_tpu_torch.models.orb import OrbExtractor
    from rgbdslam_v2_tpu_torch.ops import dct_wire, detect, fast, registration
    from rgbdslam_v2_tpu_torch.ops.image import resize_bilinear
    from rgbdslam_v2_tpu_torch.pipeline import SlamPipeline

    dev = backend.resolve_device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    phase(smi_line)
    t0 = time.perf_counter()
    libs = ["detect_corners", "kabsch", "compact_ingest", "png_unfilter"]
    lib_paths = backend.build_kernel_libraries(libs)
    for name in libs:
        backend.load_kernel_library(name)
    native_compact.library()
    build_s = time.perf_counter() - t0
    cxx = backend.host_compiler()
    host_cxx = " ".join([Path(cxx[0]).name, *cxx[1:]])
    phase(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | detect_corners and kabsch (nvcc), the host wire "
          f"encoder native/compact_ingest.cpp and the PNG unfilter csrc/png_unfilter.cpp "
          f"({host_cxx}) built in parallel in "
          f"{build_s:.2f} s ({', '.join(p.name for p in lib_paths)})")

    # ---- 2. kernel against plain: the frame's 4 levels, one launch ------
    world = SyntheticWorld.create(seed=WORLD_SEED, cam=TUM_DEFAULT)
    _, rgb0, _ = render_sequence(world, 1, seed=2, device=dev)
    rgb = torch.from_numpy(rgb0[0]).to(dev).to(torch.int32)
    gray8 = (rgb[..., 0] * 77 + rgb[..., 1] * 150 + rgb[..., 2] * 29) >> 8  # ingest's luma
    gray = gray8.float() * (1.0 / 255.0)
    with torch.inference_mode():
        images = OrbExtractor().pyramid(gray)
        shapes = [tuple(img.shape) for img in images]
        for img in images[1:]:  # written into padded rows: the unpadded bits
            if not torch.equal(img, resize_bilinear(gray, tuple(img.shape))):
                fail(f"the padded resize to {tuple(img.shape)} differs from the unpadded one")
        max_abs = 0.0
        for thr in THRESHOLDS:
            maps = detect.detect_pyramid(images, thr)
            counts = []
            for img, got in zip(images, maps):
                ref = fast.detect_corners(img, thr)
                torch.cuda.synchronize()
                mg, mr = torch.isfinite(got), torch.isfinite(ref)
                if not torch.equal(mg, mr):
                    fail(f"corner mask differs at {tuple(img.shape)}, threshold {thr}: "
                         f"{int((mg != mr).sum())} pixels")
                err = float((got[mr] - ref[mr]).abs().max()) if bool(mr.any()) else 0.0
                if err != 0.0 or not torch.equal(got, ref):
                    fail(f"scores differ at {tuple(img.shape)}, threshold {thr}: "
                         f"max abs err {err:.3e}")
                max_abs = max(max_abs, err)
                counts.append(int(mr.sum()))
            if min(counts) < 50:
                fail(f"only {min(counts)} corners on a level at threshold {thr}")
            phase(f"[2 kernel] threshold {thr}: one launch, 4 levels "
                  f"{' / '.join(f'{h}x{w}' for h, w in shapes)}: masks equal, max abs err "
                  f"0.0, corners {' / '.join(map(str, counts))}")

        px_frame = sum(h * w for h, w in shapes)
        times = {}
        for key, px, call in (
            ("level0", shapes[0][0] * shapes[0][1],
             lambda: detect.detect_pyramid(images[:1], 0.06)),
            ("level0_plain", None, lambda: fast.detect_corners(images[0], 0.06)),
            ("frame", px_frame, lambda: detect.detect_pyramid(images, 0.06)),
            ("frame_plain", None, lambda: [fast.detect_corners(im, 0.06) for im in images]),
        ):
            times[key] = (device_ms(call), median_ms(call))
            if px is not None:
                bytes_ms = 8.0 * px / HBM_BYTES_PER_S * 1e3
                ops_ms = DETECT_OPS_PER_PX * px / FP32_OPS_PER_S * 1e3
                bound = max(bytes_ms, ops_ms)
                times[key + "_bound"] = (bound, "bytes" if bytes_ms >= ops_ms else "operations")
        for key, label in (("level0", "480x640 (level 0 alone)"), ("frame", "frame (4 levels)")):
            (dk, ek), (dp, ep) = times[key], times[key + "_plain"]
            bound, by = times[key + "_bound"]
            share = "not measured" if dk is None else f"{100.0 * bound / dk:.1f}%"
            phase(f"[2 kernel] {label}: kernel device {fmt_ms(dk)} (profiler, mean of 20), "
                  f"event span {ek:.4f} ms (median of 20); plain device {fmt_ms(dp)}, event "
                  f"span {ep:.4f} ms; bound {bound * 1e3:.3f} us ({by}); share of bound {share}")
        stage = device_ms(lambda: detect.detect_pyramid(OrbExtractor().pyramid(gray), 0.06))
        phase(f"[2 kernel] pyramid + detect stage a frame (three resizes written in place, one "
              f"launch): device {fmt_ms(stage)} (profiler, mean of 20)")

        # the Kabsch kernel against its plain version
        kab_err = 0.0
        for n_pts in (64, 300):
            src, dst, w = (torch.from_numpy(a).to(dev)
                           for a in kabsch_problems(np.random.default_rng(n_pts), 1000, n_pts))
            got = alignment.weighted_kabsch(src, dst, w)
            ref = alignment.weighted_kabsch_plain(src.double(), dst.double(),
                                                  w.double()).float()
            ref32 = alignment.weighted_kabsch_plain(src, dst, w)
            torch.cuda.synchronize()
            err_r = float((got[:, :3, :3] - ref[:, :3, :3]).abs().max())
            err_t = float((got[:, :3, 3] - ref[:, :3, 3]).abs().max())
            err32 = [float((got[:, :3, c] - ref32[:, :3, c]).abs().max())
                     for c in (slice(0, 3), 3)]
            phase(f"[2 kabsch] 1000 problems of {n_pts} points, against the plain version in "
                  f"float64: max abs err R {err_r:.3e}, t {err_t:.3e} m (limit {KABSCH_TOL}); "
                  f"against it in float32: R {err32[0]:.3e}, t {err32[1]:.3e} m")
            if not (err_r <= KABSCH_TOL and err_t <= KABSCH_TOL):
                fail(f"Kabsch kernel differs from the plain version at N={n_pts}: "
                     f"R {err_r:.3e}, t {err_t:.3e}")
            kab_err = max(kab_err, err_r, err_t)
        zero = alignment.weighted_kabsch(src[:8], dst[:8], torch.zeros_like(w[:8]))
        zero_ref = alignment.weighted_kabsch_plain(src[:8], dst[:8], torch.zeros_like(w[:8]))
        line = torch.linspace(-1.0, 1.0, 300, device=dev)[:, None] * torch.tensor(
            [0.3, -0.5, 0.8], device=dev)
        rank1 = alignment.weighted_kabsch(line[None], 0.5 * line[None] + 2.0,
                                          torch.ones(1, 300, device=dev))[0, :3, :3].double()
        orth = float((rank1 @ rank1.T - torch.eye(3, device=dev, dtype=torch.float64))
                     .abs().max())
        det1 = float(torch.linalg.det(rank1))
        phase(f"[2 kabsch] zero weights: kernel R = I and t = 0: "
              f"{bool(torch.equal(zero, torch.eye(4, device=dev).expand(8, 4, 4)))}, plain "
              f"version equal: {bool(torch.equal(zero, zero_ref))}; collinear points: "
              f"|R R^T - I| {orth:.2e}, det R {det1:.6f}")
        if not torch.equal(zero, torch.eye(4, device=dev).expand(8, 4, 4)):
            fail("Kabsch kernel with zero weights is not the identity")
        if not (orth < KABSCH_TOL and abs(det1 - 1.0) < KABSCH_TOL):
            fail(f"Kabsch kernel on collinear points is not a rotation: {orth}, {det1}")
        # timing at the main path's shape: 8 candidates x max_matches 300
        src, dst, w = (torch.from_numpy(a).to(dev)
                       for a in kabsch_problems(np.random.default_rng(8), 8, 300))
        H, _, _ = alignment._centered_cross_cov(src, dst, w)
        kab_times = {
            "kernel": (device_ms(lambda: alignment.weighted_kabsch(src, dst, w)),
                       median_ms(lambda: alignment.weighted_kabsch(src, dst, w))),
            "plain": (device_ms(lambda: alignment.weighted_kabsch_plain(src, dst, w)),
                      median_ms(lambda: alignment.weighted_kabsch_plain(src, dst, w))),
            "library": (device_ms(lambda: torch.linalg.det(torch.linalg.svd(H)[0])),
                        median_ms(lambda: torch.linalg.det(torch.linalg.svd(H)[0]))),
        }
        kab_bytes_ms = (8 * 300 * 7 * 4 + 8 * 16 * 4) / HBM_BYTES_PER_S * 1e3
        kab_ops_ms = (8 * 300 * KABSCH_OPS_PER_POINT + 8 * KABSCH_OPS_PER_PROBLEM) \
            / FP32_OPS_PER_S * 1e3
        kab_bound = max(kab_bytes_ms, kab_ops_ms)
        kab_by = "bytes" if kab_bytes_ms >= kab_ops_ms else "operations"
        phase(f"[2 kabsch] 8 x 300 (one refit of the main path): kernel device "
              f"{fmt_ms(kab_times['kernel'][0])}, event span {kab_times['kernel'][1]:.4f} ms; "
              f"plain device {fmt_ms(kab_times['plain'][0])}, event span "
              f"{kab_times['plain'][1]:.4f} ms; torch.linalg.svd + det alone device "
              f"{fmt_ms(kab_times['library'][0])}, event span {kab_times['library'][1]:.4f} ms; "
              f"bound {kab_bound * 1e3:.4f} us ({kab_by})")

        # the RANSAC refine kernel against its plain version
        ref_err = 0.0
        for n_cand in (512, 8):
            probs = [torch.from_numpy(a).to(dev)
                     for a in refine_problems(np.random.default_rng(n_cand), n_cand, 300)]
            r = refine_against_plain(probs)
            phase(f"[2 refine] {n_cand} candidates x 300 matches, {REFINE_ITERATIONS} refits, "
                  f"against the plain version in float64: max abs err T {r['err_t']:.3e} (limit "
                  f"{KABSCH_TOL}), inlier masks differ at {r['mask_diff']} matches, {r['near']} "
                  f"within {NEAR_THRESHOLD} x max_mahal_sq of the threshold, rmse rel err "
                  f"{r['err_rmse']:.2e} (limit {REFINE_RMSE_RTOL}); inliers a candidate "
                  f"{float(r['got'][2].float().mean()):.1f} of {float(probs[5].sum(-1).float().mean()):.1f} "
                  f"valid; against it in float32: T {r['err_t32']:.3e}, masks differ at "
                  f"{r['mask_diff32']}, n_inliers by up to {r['n_diff32']}")
            if not r["ok"]:
                fail(f"refine kernel differs from the plain version ({n_cand} candidates): "
                     f"{ {k: v for k, v in r.items() if k not in ('got', 'ref')} }")
            ref_err = max(ref_err, r["err_t"])
        # degenerate candidates: no valid match; zero weights (T2 = I)
        deg = [a.clone() for a in probs]
        deg[5][0] = False
        deg[6][0] = torch.eye(4, device=dev)
        deg[7][0] = False
        deg[2][1] = 0.0
        r = refine_against_plain(deg)
        got, ref = r["got"], r["ref"]
        phase(f"[2 refine] no valid match: T kept {bool(torch.equal(got[0][0], deg[6][0]))}, "
              f"n_inliers {int(got[2][0])}, rmse {float(got[3][0])}; zero weights: T equal to "
              f"the plain version's within {float((got[0][1] - ref[0][1]).abs().max()):.1e}; all "
              f"checks as above: {r['ok']}")
        if not (r["ok"] and torch.equal(got[0][0], deg[6][0]) and int(got[2][0]) == 0
                and float(got[3][0]) == 0.0):
            fail("refine kernel on degenerate candidates differs from the plain version")
        # timing at the main path's shape: 8 candidates x 300 matches, 4 refits
        refine_args = (*probs, REFINE_ITERATIONS, MAX_MAHAL_SQ)

        def old_route():  # the parent's step: the plain loop, its fits on the Kabsch kernel
            with patched(registration, "weighted_kabsch_plain", alignment.weighted_kabsch):
                return registration.ransac_refine_plain(*refine_args)
        ref_times = {
            "kernel": (device_ms(lambda: registration.ransac_refine(*refine_args)),
                       median_ms(lambda: registration.ransac_refine(*refine_args))),
            "plain": (device_ms(lambda: registration.ransac_refine_plain(*refine_args)),
                      median_ms(lambda: registration.ransac_refine_plain(*refine_args))),
            "old_route": (device_ms(old_route), median_ms(old_route)),
        }
        old_ops = device_ops(old_route)
        n_valid = probs[5].sum(-1).double()
        n_inl = registration.ransac_refine(*refine_args)[2].double()
        ref_bytes = 8 * (300 * 55 + 2 * 64 + 8)  # 54 B a match in, 1 out; T in and out, n, rmse
        ref_bytes_ms = ref_bytes / HBM_BYTES_PER_S * 1e3
        ref_ops = float((REFINE_ITERATIONS * (n_inl * REFINE_FIT_OPS_PER_MATCH
                                              + KABSCH_OPS_PER_PROBLEM)
                         + (REFINE_ITERATIONS + 1) * n_valid * REFINE_GATE_OPS_PER_MATCH).sum())
        ref_ops_ms = ref_ops / FP64_OPS_PER_S * 1e3
        ref_bound = max(ref_bytes_ms, ref_ops_ms)
        ref_by = "bytes" if ref_bytes_ms >= ref_ops_ms else "operations"
        dk = ref_times["kernel"][0]
        phase(f"[2 refine] 8 x 300, {REFINE_ITERATIONS} refits (one frame's refinement): kernel "
              f"device {fmt_ms(dk)}, event span {ref_times['kernel'][1]:.4f} ms; plain device "
              f"{fmt_ms(ref_times['plain'][0])}, event span {ref_times['plain'][1]:.4f} ms; old "
              f"route ({REFINE_ITERATIONS} Kabsch launches + torch ops) device "
              f"{fmt_ms(ref_times['old_route'][0])}, event span "
              f"{ref_times['old_route'][1]:.4f} ms, {old_ops} device ops; bound "
              f"{ref_bound * 1e3:.4f} us ({ref_by}: {ref_bytes} B, {ref_ops:.0f} float64 ops); "
              f"share of bound "
              f"{'not measured' if dk is None else f'{100.0 * ref_bound / dk:.2f}%'}")

        # the projective stage (g2o_transformation_refinement) in the same launch
        pj = registration.Projective(PROJ_ITERATIONS, 525.0, 525.0, 319.5, 239.5, 0.01)
        proj_err = 0.0
        for n_cand in (64, 8):
            probs_p = [torch.from_numpy(a).to(dev)
                       for a in refine_problems(np.random.default_rng(n_cand), n_cand, 300)]
            before = registration.LAUNCHES
            r = refine_against_plain(probs_p, projective=pj)
            launched = registration.LAUNCHES - before
            phase(f"[2 projective] {n_cand} candidates x 300 matches, {REFINE_ITERATIONS} "
                  f"refits + {PROJ_ITERATIONS} projective iterations in {launched} launch, "
                  f"against the plain version in float64: max abs err T {r['err_t']:.3e} "
                  f"(limit {KABSCH_TOL}), inlier masks differ at {r['mask_diff']} matches, "
                  f"{r['near']} within {NEAR_THRESHOLD} x max_mahal_sq of the threshold, rmse "
                  f"rel err {r['err_rmse']:.2e} (limit {REFINE_RMSE_RTOL}); against it in "
                  f"float32: T {r['err_t32']:.3e}, masks differ at {r['mask_diff32']}")
            if not r["ok"] or launched != 1:
                fail(f"refine kernel with the projective stage differs from the plain version "
                     f"({n_cand} candidates, {launched} launches): "
                     f"{ {k: v for k, v in r.items() if k not in ('got', 'ref')} }")
            proj_err = max(proj_err, r["err_t"])
        proj_args = (*probs, REFINE_ITERATIONS, MAX_MAHAL_SQ, pj)
        proj_times = {
            "kernel": (device_ms(lambda: registration.ransac_refine(*proj_args)),
                       median_ms(lambda: registration.ransac_refine(*proj_args))),
            "plain": (device_ms(lambda: registration.ransac_refine_plain(*proj_args)),
                      median_ms(lambda: registration.ransac_refine_plain(*proj_args))),
        }
        # the stage's work on these inputs: a re-gate and the kept-or-not gate
        # of every valid match, the iterations over the re-gated inliers
        T_stage = registration.ransac_refine(*refine_args)[0]
        m2_stage = registration.mahalanobis_sq(T_stage, probs[0], probs[1], probs[3], probs[4])
        n_stage = (probs[5] & (m2_stage < MAX_MAHAL_SQ)).sum(-1).double()
        proj_ops = ref_ops + float((2 * n_valid * REFINE_GATE_OPS_PER_MATCH
                                    + PROJ_ITERATIONS * (n_stage * PROJ_OPS_PER_MATCH
                                                         + PROJ_OPS_PER_SOLVE)).sum())
        proj_ops_ms = proj_ops / FP64_OPS_PER_S * 1e3
        proj_bound = max(ref_bytes_ms, proj_ops_ms)
        proj_by = "bytes" if ref_bytes_ms >= proj_ops_ms else "operations"
        dpk = proj_times["kernel"][0]
        phase(f"[2 projective] 8 x 300, {REFINE_ITERATIONS} refits + {PROJ_ITERATIONS} "
              f"projective iterations (one frame's refinement under "
              f"g2o_transformation_refinement={PROJ_ITERATIONS}): kernel device {fmt_ms(dpk)}, "
              f"event span {proj_times['kernel'][1]:.4f} ms (without the stage: "
              f"{fmt_ms(dk)}); plain device {fmt_ms(proj_times['plain'][0])}, event span "
              f"{proj_times['plain'][1]:.4f} ms; bound {proj_bound * 1e3:.4f} us ({proj_by}: "
              f"{ref_bytes} B, {proj_ops:.0f} float64 ops); share of bound "
              f"{'not measured' if dpk is None else f'{100.0 * proj_bound / dpk:.2f}%'}")

    # ---- 3. main path --------------------------------------------------
    t0 = time.perf_counter()
    poses, rgbs, depths, stamps = render_bench(world, args.frames, dev)
    phase(f"[3 main] rendered {args.frames} frames 640x480 on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    spec = dct_wire.spec("2.7")
    n_luma = dct_wire.dct_luma_len(480, 640, spec)
    worst, n_diff = 0, 0
    for i in range(0, 20):
        wire = ingest.compact_frame(rgbs[i], depths[i], 2, 10, spec)[:n_luma]
        ref = dct_wire.decode_luma_dct_np(wire, 480, 640, spec).astype(np.int16)
        got = dct_wire.decode_luma_dct_dev(torch.from_numpy(wire).to(dev), 480, 640, spec)
        diff = np.abs(got.cpu().numpy().astype(np.int16) - ref)
        worst, n_diff = max(worst, int(diff.max())), n_diff + int((diff > 0).sum())
    phase(f"[3 ydct] luma decode on the card vs numpy, 20 frames at quality 2.7: "
          f"{n_diff} pixels differ, max difference {worst}")
    if worst > 1:
        fail(f"ydct decode on the card differs from numpy by {worst} grey levels")
    detect.reset_launches()  # count only the main path's launches
    alignment.reset_launches()
    registration.reset_launches()
    ingest.reset_encodes()
    pipe = SlamPipeline(TUM_DEFAULT, bench_params(), device=dev)
    for i in range(WARMUP):
        pipe.process_frame(rgbs[i], depths[i], float(stamps[i]),
                           gt_pose=poses[0] if i == 0 else None)
    pipe.manager.optimize(blocking=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.params.set("skip_first_n_frames", WARMUP)
    pipe.run_arrays(rgbs[:n_main], depths[:n_main], stamps[:n_main])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = detect.LAUNCHES
    kab_launches_keepall = alignment.LAUNCHES
    ref_launches_keepall = registration.LAUNCHES
    fps = (n_main - WARMUP) / dt
    stats = pipe.manager.statistics()
    phase(f"[3 main] {fps:.2f} fps over {n_main - WARMUP} frames "
          f"({1e3 * dt / (n_main - WARMUP):.2f} ms/frame, compact encode included); "
          f"nodes {stats['nodes']}, edges {stats['edges']} ({stats['active_edges']} active, "
          f"{stats['sequential_edges']} sequential, {stats['loop_edges']} loop), keyframes "
          f"{stats['keyframes']}; detect launches {launches}, refine launches "
          f"{ref_launches_keepall}, Kabsch launches {kab_launches_keepall}; yc12 host encodes "
          f"by route {ingest.ENCODES}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if pipe.n_processed != n_main or stats["nodes"] != n_main:
        fail(f"processed {pipe.n_processed} frames, {stats['nodes']} nodes; "
             f"expected {n_main}")
    if launches != pipe.n_processed:
        fail(f"detect kernel launched {launches} times, expected one a frame "
             f"({pipe.n_processed})")
    if ref_launches_keepall != pipe.n_processed - 1 or kab_launches_keepall:
        fail(f"refine kernel launched {ref_launches_keepall} times, Kabsch kernel "
             f"{kab_launches_keepall} times; expected one refine a frame after the first and "
             f"no Kabsch")

    # ---- 4. protocol ---------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps[:n_main]),
                                       gt_xyz=poses[:n_main, :3, 3])
    est = pipe.manager.poses()
    if est.shape != (n_main, 4, 4) or not np.isfinite(est).all():
        fail(f"trajectory has shape {est.shape} or non-finite poses")
    ate = [rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)]
    phase(f"[4 protocol] ATE L0..L4 {' / '.join(f'{a:.4f}' for a in ate)} m "
          f"(in {time.perf_counter() - t0:.1f} s; limit L4 <= {ATE_L4_MAX})")
    if not all(np.isfinite(ate)):
        fail(f"protocol ATE not finite: {ate}")
    if ate[4] > ATE_L4_MAX:
        fail(f"protocol ATE L4 {ate[4]:.4f} m above {ATE_L4_MAX} m")

    # ---- 5. default configuration -------------------------------------
    del pipe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    detect.reset_launches()
    alignment.reset_launches()
    registration.reset_launches()
    pipe = SlamPipeline(TUM_DEFAULT, default_params(), device=dev)
    mgr = pipe.manager
    online_ms = []
    online = mgr.optimize

    def timed_optimize(*a, **kw):  # host clock around one synchronized optimize
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = online(*a, **kw)
        torch.cuda.synchronize()
        online_ms.append(1e3 * (time.perf_counter() - t))
        return out

    mgr.optimize = timed_optimize
    sl = slice(0, n_default)
    pipe.run_arrays(rgbs[:WARMUP], depths[:WARMUP], stamps[:WARMUP], gt_poses=poses[sl])
    torch.cuda.synchronize()
    online_ms.clear()
    t0 = time.perf_counter()
    pipe.run_arrays(rgbs[WARMUP:n_default], depths[WARMUP:n_default], stamps[WARMUP:n_default])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del mgr.optimize
    launches_default = detect.LAUNCHES
    kab_launches_default = alignment.LAUNCHES
    ref_launches_default = registration.LAUNCHES
    fps_default = (n_default - WARMUP) / dt
    stats = mgr.statistics()
    n_const = sum(t == EDGE_CONST_POSITION for t in mgr.host.edge_types)
    peak_default = torch.cuda.max_memory_allocated() / 2**30
    phase(f"[5 default] {fps_default:.2f} fps over {n_default - WARMUP} frames "
          f"({1e3 * dt / (n_default - WARMUP):.2f} ms/frame, compact encode included); "
          f"nodes {stats['nodes']}, dropped frames {pipe.n_dropped}, edges {stats['edges']} "
          f"({stats['sequential_edges']} sequential, {stats['loop_edges']} loop, {n_const} "
          f"constant-position), keyframes {stats['keyframes']}; detect launches "
          f"{launches_default} for {pipe.n_processed} frames, refine launches "
          f"{ref_launches_default}, Kabsch launches {kab_launches_default}; online optimize "
          f"median "
          f"{statistics.median(online_ms):.2f} ms over {len(online_ms)} calls "
          f"(min {min(online_ms):.2f}, max {max(online_ms):.2f}); solver calls "
          f"{mgr.solver_calls}; peak device memory {peak_default:.2f} GiB")
    if pipe.n_processed != n_default or stats["nodes"] + pipe.n_dropped != n_default:
        fail(f"processed {pipe.n_processed} frames: {stats['nodes']} nodes and "
             f"{pipe.n_dropped} dropped; expected {n_default} frames")
    if launches_default != pipe.n_processed:
        fail(f"detect kernel launched {launches_default} times on the default path, "
             f"expected one a frame ({pipe.n_processed})")
    if ref_launches_default != pipe.n_processed - 1 or kab_launches_default:
        fail(f"refine kernel launched {ref_launches_default} times, Kabsch kernel "
             f"{kab_launches_default} times on the default path; expected one refine a frame "
             f"after the first and no Kabsch")
    n_default_frames = pipe.n_processed
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps[sl]),
                                       gt_xyz=poses[sl, :3, 3])
    est = mgr.poses()
    if est.shape != (stats["nodes"], 4, 4) or not np.isfinite(est).all():
        fail(f"default-configuration trajectory has shape {est.shape} or non-finite poses")
    ate_d = [rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)]
    phase(f"[5 default] protocol ATE L0..L4 {' / '.join(f'{a:.4f}' for a in ate_d)} m "
          f"(in {time.perf_counter() - t0:.1f} s; limit L4 <= {DEFAULT_ATE_L4_MAX:.4f}); "
          f"solver calls {mgr.solver_calls}")
    if mgr.solver_calls["dense"] or not mgr.solver_calls["pcg"]:
        fail(f"the default configuration's optimize used the dense solver: "
             f"{mgr.solver_calls}")
    if not all(np.isfinite(ate_d)):
        fail(f"default-configuration ATE not finite: {ate_d}")
    if ate_d[4] > DEFAULT_ATE_L4_MAX:
        fail(f"default-configuration ATE L4 {ate_d[4]:.4f} m above {DEFAULT_ATE_L4_MAX:.4f} m")

    # ---- 6. bench configuration: make_pipe as bench.py writes it ---------
    del pipe, mgr, online, timed_optimize  # the closure holds the manager
    torch.cuda.empty_cache()
    b = bench_config_run(poses, rgbs, depths, stamps, dev)
    launches_bench, kab_launches_bench = b["detect_launches"], b["kabsch_launches"]
    ref_launches_bench = b["refine_launches"]
    stats = b["stats"]
    phase(f"[6 bench] make_pipe as bench.py sets it (ydct 2.7, 4 frames a step, encode-ahead, "
          f"pipelined drains, inaffected): {b['fps']:.2f} fps over {args.frames - WARMUP} "
          f"frames ({b['ms_per_frame']:.2f} ms/frame, host encode included); nodes "
          f"{stats['nodes']}, edges {stats['edges']} ({stats['active_edges']} active, "
          f"{stats['sequential_edges']} sequential, {stats['loop_edges']} loop, "
          f"{b['const_edges']} constant-position), keyframes {stats['keyframes']}")
    phase(f"[6 bench] detect launches {launches_bench} for {args.frames} frames; refine "
          f"launches {ref_launches_bench} = {ref_launches_bench / (args.frames - 1):.3f} a frame "
          f"after the first; Kabsch launches {kab_launches_bench}; CUDA graphs captured "
          f"{b['captures']}, eager warm-up groups "
          f"{b['eager_groups']}, replays {b['replays']} (host {b['replay_host_ms']:.3f} ms a "
          f"replay call); synchronizing calls: {b['replay_syncs']} in {b['replay_groups']} "
          f"replayed groups, {len(b['setup_sites'])} in {b['setup_groups']} warm-up/capture "
          f"groups ({sorted(set(b['setup_sites']))}); waits for a copy not landed "
          f"{b['replay_waits']} in replayed groups ({b['copy_waits']} in all), of which left "
          f"the card idle {b['replay_idle']} ({b['idle_waits']}); host ydct encodes by route "
          f"{b['encodes']}, {b['encode_ms']:.3f} ms/frame (main thread, 20 frames, outside "
          f"the run); peak device memory {b['peak_gib']:.2f} GiB")
    if stats["nodes"] != args.frames:
        fail(f"bench configuration: {stats['nodes']} nodes for {args.frames} frames")
    if launches_bench != args.frames:
        fail(f"bench configuration: detect launched {launches_bench} times for "
             f"{args.frames} frames")
    if ref_launches_bench != args.frames - 1 or kab_launches_bench:
        fail(f"bench configuration: refine launched {ref_launches_bench} times, Kabsch "
             f"{kab_launches_bench} times; expected one refine a frame after the first and no "
             f"Kabsch")
    if not b["replays"] or b["replay_syncs"] or b["replay_idle"]:
        fail(f"bench configuration: {b['replays']} replays; in {b['replay_groups']} replayed "
             f"groups {b['replay_syncs']} synchronizing calls ({sorted(set(b['replay_sites']))}) "
             f"and {b['replay_idle']} waits that left the card idle")
    if b["encodes"]["numpy"] or not b["encodes"]["native"]:
        fail(f"bench configuration: host encodes by route {b['encodes']}; the native "
             f"encoder must take every frame")
    ate_b = b["ate"]
    phase(f"[6 bench] protocol ATE L0..L4 {' / '.join(f'{a:.4f}' for a in ate_b)} m "
          f"(in {b['protocol_s']:.1f} s; limit L4 <= {ATE_L4_MAX})")
    if not b["poses_ok"]:
        fail("bench-configuration trajectory has the wrong shape or non-finite poses")
    if not all(np.isfinite(ate_b)) or ate_b[4] > ATE_L4_MAX:
        fail(f"bench-configuration ATE {ate_b}: not finite or L4 above {ATE_L4_MAX} m")

    # ---- 7. grouped replay against one frame a step, eager ----------------
    sl = slice(0, EQUAL_FRAMES)
    eq7 = replay_vs_eager(poses[sl], rgbs[sl], depths[sl], stamps[sl], dev, 4)
    phase(f"[7 equal] 4 frames a step replayed ({eq7['replays']} replays) vs 1 frame a step "
          f"eager, {EQUAL_FRAMES} frames: max pose difference {eq7['diff']:.3e}; active edges "
          f"{eq7['active']}; statistics equal: {eq7['stats_equal']}")
    if not eq7["replays"] or eq7["diff"] > 1e-6 or not eq7["stats_equal"]:
        fail("the replayed groups differ from the eager steps")

    # ---- 8. the host wire encoder: native against numpy ------------------
    torch.cuda.empty_cache()
    enc = encode_check(rgbs, depths, dev)
    n_frames = len(rgbs)
    share = enc["code_diff"] / enc["codes"]
    phase(f"[8 encode] {n_frames} frames 640x480, stride 2, 10-bit depth, host encoder "
          f"{host_cxx}: yc12 native bytes equal numpy on {enc['yc12_equal']} of {n_frames} "
          f"frames; ydct 2.7 codes differ at {enc['code_diff']} of {enc['codes']} "
          f"({share:.2e}), by at most {enc['code_max']}; decodes: card vs numpy of the native "
          f"wire max {enc['dec_dev']} grey levels; numpy of the native vs of the numpy wire max "
          f"{enc['dec_enc']} ({enc['dec_unexplained']} pixels beyond what the code differences "
          f"move), card of native vs numpy of numpy max {enc['dec_cross']}")
    phase("[8 encode] host ms a frame (one thread): "
          + "; ".join(f"{k} {v}" for k, v in enc["times"].items()))
    if enc["yc12_equal"] != n_frames:
        fail(f"native yc12 bytes differ from numpy on {n_frames - enc['yc12_equal']} frames")
    if enc["code_max"] > 1 or enc["dec_dev"] > 1 or enc["dec_unexplained"]:
        fail(f"native ydct: codes differ by {enc['code_max']}, the card's decode by "
             f"{enc['dec_dev']} grey levels, {enc['dec_unexplained']} pixels beyond what the "
             f"code differences explain")

    # ---- 9. fr2 scale: make_pipe(4096, 65536), 4 rounds ------------------
    f2 = fr2_run(rgbs, depths, dev)
    st = f2["stats"]
    phase(f"[9 fr2] make_pipe(4096, 65536), {FR2_ROUNDS} x {n_frames} frames: "
          + ", ".join(f"round {r} {fps:.2f} fps at {nodes} nodes"
                      for r, (nodes, fps) in enumerate(f2["chunks"]))
          + f"; nodes {st['nodes']}, active edges {st['active_edges']} ({st['loop_edges']} "
          f"loop); detect launches {f2['launches'][0]}, refine {f2['launches'][1]}, Kabsch "
          f"{f2['launches'][2]}; CUDA graphs captured {f2['captures']}, replays "
          f"{f2['replays']}, synchronizing calls in replayed groups {len(f2['replay_syncs'])}, "
          f"waits there for a copy not landed {f2['replay_waits']} ({f2['replay_idle']} left "
          f"the card idle); peak device memory {f2['peak_gib']:.2f} GiB")
    phase(f"[9 fr2] final blocking optimize, pose_relative_to=first: {f2['opt_ms']:.1f} ms "
          f"(host clock, synchronized), {f2['iters']} LM iterations, chi2 {f2['chi2']:.1f}, "
          f"solver {f2['solver']}")
    if st["nodes"] != f2["frames"] or not f2["poses_ok"] or not np.isfinite(f2["chi2"]):
        fail(f"fr2 scale: {st['nodes']} nodes for {f2['frames']} frames, poses finite "
             f"{f2['poses_ok']}, chi2 {f2['chi2']}")
    if f2["launches"][0] != f2["frames"] or f2["launches"][1] != f2["frames"] - 1:
        fail(f"fr2 scale: detect launched {f2['launches'][0]}, refine {f2['launches'][1]} "
             f"times for {f2['frames']} frames")
    if not f2["replays"] or f2["replay_syncs"] or f2["replay_idle"]:
        fail(f"fr2 scale: {f2['replays']} replays, synchronizing calls in replayed groups "
             f"{sorted(set(f2['replay_syncs']))}, waits that left the card idle "
             f"{f2['replay_idle']}")
    launches_phase = {"fr2": f2["launches"]}

    # ---- 10. spin360: bench.py's phase 3 ----------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seq = render_hard("spin360", n_spin, dev)
    render_s = time.perf_counter() - t0
    sp3 = bench_config_run(*seq[:4], dev)
    ate_s, st = sp3["ate"], sp3["final_stats"]
    phase(f"[10 spin360] {n_spin} frames 640x480 of spin_trajectory(seed=2, 3 deg/frame) "
          f"rendered on the card in {render_s:.1f} s, make_pipe: {sp3['fps']:.2f} fps; "
          f"protocol ATE L0..L4 {' / '.join(f'{a:.4f}' for a in ate_s)} m (limit L1 <= "
          f"{SPIN_L1_MAX}; the reference's fr1_360: 0.051 m); nodes {st['nodes']}, active "
          f"edges {st['active_edges']}, constant-position edges {sp3['const_edges']}, GICP "
          f"rescues {st['icp_rescues']} (make_pipe runs without use_icp); detect launches "
          f"{sp3['detect_launches']}, refine {sp3['refine_launches']}; replays "
          f"{sp3['replays']}, synchronizing calls in replayed groups {sp3['replay_syncs']}, "
          f"waits there for a copy not landed {sp3['replay_waits']} ({sp3['replay_idle']} "
          f"left the card idle)")
    if not np.isfinite(ate_s[1]) or ate_s[1] > SPIN_L1_MAX or not sp3["poses_ok"]:
        fail(f"spin360: ATE {ate_s} (L1 limit {SPIN_L1_MAX}), poses finite {sp3['poses_ok']}")
    if (sp3["detect_launches"] != n_spin or sp3["refine_launches"] != n_spin - 1
            or sp3["replay_syncs"] or sp3["replay_idle"]):
        fail(f"spin360: detect {sp3['detect_launches']}, refine {sp3['refine_launches']} "
             f"launches, {sp3['replay_syncs']} syncs and {sp3['replay_idle']} waits that left "
             f"the card idle in {sp3['replay_groups']} replayed groups")
    launches_phase["spin360"] = (sp3["detect_launches"], sp3["refine_launches"],
                                 sp3["kabsch_launches"])

    # ---- 11. hard sequences with the GICP rescue ---------------------------
    hard = {}
    for name in HARD:
        torch.cuda.empty_cache()
        seq = render_hard(name, n_hard, dev)
        r = bench_config_run(*seq[:4], dev, keep=True, use_icp=True)
        mgr = r.pop("pipe").manager
        # frame k's fallback edge is the last of its B + 1 reserved slots; a
        # rescue retypes it sequential
        B1 = mgr.cand_batch + 1
        rescued = [k for k in range(1, n_hard) if mgr.host.edge_types[k * B1 - 1] == 0]
        nid = rescued[0] if rescued else n_hard // 2
        r["timing"] = rescue_item_ms(mgr, nid)
        r["timed_node"] = nid
        r["rescue_err"] = rescue_edge_errors(mgr, seq[0])
        del mgr
        hard[name] = r
        tm, st, ate_h = r["timing"], r["final_stats"], r["ate"]
        phase(f"[11 hard] {name} ({seq[4]}), {n_hard} frames 640x480, make_pipe + "
              f"use_icp: {r['fps']:.2f} fps; ATE L0..L4 {' / '.join(f'{a:.4f}' for a in ate_h)} "
              f"m; constant-position edges {r['const_edges']}, GICP rescues "
              f"{st['icp_rescues']} of {r['rescue_items']} items sent; device ms a rescue item "
              f"(node {nid}, {tm['iterations']} GICP iterations) {fmt_ms(tm['item_ms'])}, of "
              f"which the distance matrix + row minimum {fmt_ms(tm['nearest_ms'])} a call x "
              f"{tm['iterations']} ({tm['shape'][0]} x {tm['shape'][1]} points); detect "
              f"launches {r['detect_launches']}, refine {r['refine_launches']}")
        phase(f"[11 hard] {name}: replayed groups {r['replay_groups']}, synchronizing calls "
              f"in them {r['replay_syncs']} = blocking drain copies {r['replay_pulls']} + "
              f"{r['unexplained_syncs']} others; {r['rescue_groups']} groups ran with rescues "
              f"in flight and no blocking drain, with {r['rescue_group_syncs']} synchronizing "
              f"calls and {r['rescue_group_waits']} waits for copies not landed, "
              f"{r['rescue_group_idle']} of them leaving the card idle (all replayed groups: "
              f"{r['replay_waits']}, {r['replay_idle']}); peak device memory "
              f"{r['peak_gib']:.2f} GiB")
        phase(f"[11 hard] {name}: {fmt_rescue_errors(r['rescue_err'])}")
        if not all(np.isfinite(ate_h)) or not r["poses_ok"]:
            fail(f"{name}: ATE {ate_h}, poses finite {r['poses_ok']}")
        if r["detect_launches"] != n_hard or r["refine_launches"] != n_hard - 1:
            fail(f"{name}: detect {r['detect_launches']}, refine {r['refine_launches']} "
                 f"launches for {n_hard} frames")
        if r["unexplained_syncs"] or r["rescue_group_syncs"] or r["rescue_group_idle"]:
            fail(f"{name}: synchronizing calls in replayed groups beyond the blocking drains "
                 f"({r['unexplained_syncs']}) or with rescues in flight "
                 f"({r['rescue_group_syncs']}): {sorted(set(r['replay_sites']))}; waits that "
                 f"left the card idle with rescues in flight {r['rescue_group_idle']}")
        if r["encodes"]["numpy"]:
            fail(f"{name}: host encodes by route {r['encodes']}")
        launches_phase[name] = (r["detect_launches"], r["refine_launches"],
                                r["kabsch_launches"])
    dark = hard["dark_stretch"]
    if dark["final_stats"]["icp_rescues"] < 1 or not dark["ate"][1] < DARK_L1_MAX:
        fail(f"dark_stretch: {dark['final_stats']['icp_rescues']} rescues, L1 "
             f"{dark['ate'][1]:.4f} m (needs >= 1 rescue and L1 < {DARK_L1_MAX:.4f})")
    e = dark["rescue_err"]
    if not e["n"] or not e["t_med"] < RESCUE_ERR_MAX * e["motion_med"]:
        fail(f"dark_stretch: the rescued edges do not beat the constant-position edges they "
             f"replace ({fmt_rescue_errors(e)}; limit {RESCUE_ERR_MAX} x the true motion)")

    # the default path's inline batched rescue on the dark stretch
    torch.cuda.empty_cache()
    poses_d, rgbs_d, depths_d, stamps_d, note = render_hard("dark_stretch", n_dicp, dev)
    sl = slice(0, n_dicp)
    detect.reset_launches()
    alignment.reset_launches()
    registration.reset_launches()
    # default_params() is a process-wide instance: a copy takes the change
    pipe = SlamPipeline(TUM_DEFAULT, ParameterServer({"use_icp": True}), device=dev)
    t0 = time.perf_counter()
    pipe.run_arrays(rgbs_d[sl], depths_d[sl], stamps_d[sl], gt_poses=poses_d[sl])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_phase["default_icp"] = (detect.LAUNCHES, registration.LAUNCHES, alignment.LAUNCHES)
    with tempfile.TemporaryDirectory() as td:
        rep = pipe.evaluation_protocol(td, gt_stamps=list(stamps_d[sl]),
                                       gt_xyz=poses_d[sl, :3, 3])
    st = rep.statistics
    ate_di = [rep.ate_rmse.get(lvl, float("nan")) for lvl in range(5)]
    phase(f"[11 hard] dark_stretch on the default path (default_params(), use_icp), "
          f"{n_dicp} frames ({note}): {n_dicp / dt:.2f} fps, nodes {st['nodes']}, "
          f"dropped {pipe.n_dropped}, GICP rescues (ICP edges) {st['icp_rescues']}; ATE L0..L4 "
          f"{' / '.join(f'{a:.4f}' for a in ate_di)} m; detect launches "
          f"{launches_phase['default_icp'][0]}, refine {launches_phase['default_icp'][1]}")
    if (launches_phase["default_icp"][0] != n_dicp
            or launches_phase["default_icp"][1] != n_dicp - 1):
        fail(f"default path with use_icp: launches {launches_phase['default_icp']}")
    if not np.isfinite(pipe.manager.poses()).all():
        fail("default path with use_icp: non-finite poses")
    del pipe

    # ---- 12. the TUM entry point: PNG codec, loader, run_tum, CLI --------
    torch.cuda.empty_cache()
    phase(f"[12 tum] the {args.frames} bench frames as a TUM directory: PNG codec, loader, "
          f"run_tum and the rgbdslam-torch CLI")
    # phase 12's TUM directories stay here for phase 15's batch evaluation
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tm = tum_phase(poses, rgbs, depths, dev, n_default, Path(work.name))
    launches_phase["tum"] = tm["launches"]
    launches_phase["tum_default"] = tm["default_launches"]
    st = tm["stats"]
    for name, how in (("up", "by the port's PNG writer (every row Up, deflate level 1)"),
                      ("adaptive", "as libpng writes them (adaptive filters, zlib level 6)")):
        dec = tm["decode"][name]
        msd = dec["ms"]
        wms = tm["write_ms" if name == "up" else "write_adaptive_ms"]
        phase(f"[12 tum] {args.frames} bench frames written as a TUM directory {how}: "
              f"{wms:.2f} ms a frame on 8 threads, {tm['png_mb'][name]:.1f} MiB, rows by filter "
              f"None/Sub/Up/Average/Paeth {'/'.join(map(str, dec['filters']))}; all decode "
              f"equal to the rendered frames (RGB bytes, depth u16); decode ms a frame (RGB + "
              f"depth PNG, one thread): {msd['total']:.2f} = read {msd['read']:.2f} + chunks, "
              f"CRCs and inflate {msd['inflate']:.2f} + C unfilter {msd['unfilter']:.2f} + "
              f"image {msd['image']:.2f}; numpy unfilter {dec['numpy_unfilter_ms']:.2f} "
              f"({UNFILTER_FRAMES if name == 'up' else UNFILTER_FRAMES_ADAPTIVE} frames, equal "
              f"to C); TumLoader ({tm['loader_threads']} threads) "
              f"{tm['loader_fps'][name]:.1f} frames/s")
    phase(f"[12 tum] rgbdslam-torch run --evaluate --save-clouds --save-octomap --save-g2o "
          f"--save-features on the adaptive directory, make_pipe: ATE L0..L4 "
          f"{' / '.join(f'{a:.4f}' for a in tm['ate'])} m (limit L4 <= {ATE_L4_MAX}), ate "
          f"subcommand {tm['ate_cli']:.6f}; nodes {st['nodes']}, active edges "
          f"{st['active_edges']}; detect launches {tm['launches'][0]}, refine "
          f"{tm['launches'][1]}, Kabsch {tm['launches'][2]}; against run_arrays on the same "
          f"frames (the decoded meters): trajectory files L0..L4 {' / '.join(f'{d:.1e}' for d in tm['traj_diff'])}, "
          f"poses {tm['pose_diff']:.3e} (limit 1e-5); outputs {tm['outputs']}; save_clouds {tm['save_ms']['save_clouds']:.0f} ms, "
          f"save_octomap {tm['save_ms']['save_octomap']:.0f} ms; whole command "
          f"{tm['cli_s']:.1f} s; peak device memory {tm['peak_gib']:.2f} GiB; replayed groups "
          f"{tm['replay_groups']}, synchronizing calls in them {tm['replay_syncs']}, waits for "
          f"a copy not landed {tm['replay_waits']} ({tm['replay_idle']} left the card idle)")
    phase(f"[12 tum] voxel map ({VOXEL_NODES} node clouds, 8.4 M voxels): card against CPU "
          f"voxels differing {tm['voxel_differ']}, {tm['voxels_hit']} voxels hit; card insert "
          f"median {tm['voxel_insert_ms']:.2f} ms a cloud (host clock, synchronized)")
    dst = tm["default_stats"]
    phase(f"[12 tum] default configuration through the CLI, "
          f"{min(n_default, TUM_DEFAULT_FRAMES)} frames: ATE L0..L4 "
          f"{' / '.join(f'{a:.4f}' for a in tm['default_ate'])} m (limit L4 <= "
          f"{DEFAULT_ATE_L4_MAX}); {tm['default_fps']:.2f} fps; nodes {dst['nodes']}, "
          f"keyframes {dst['keyframes']}; detect launches {tm['default_launches'][0]}, refine "
          f"{tm['default_launches'][1]}; whole command {tm['default_s']:.1f} s")
    for name, ck in tm["checkpoint"].items():
        phase(f"[12 tum] checkpoint after {CHECKPOINT_AT} frames ({name.replace('_', ' ')}): "
              f"save_state {ck['save_s']:.2f} s ({ck['mb']:.1f} MiB), load_state "
              f"{ck['load_s']:.2f} s; {CHECKPOINT_MORE} more frames into both, "
              f"{ck['optimizes']} online optimizes in the loaded one: max pose difference "
              f"{ck['diff']:.3e} (limit {ck['limit']}), statistics equal {ck['same_stats']}")
    host = {k: [" / ".join(f"{x:.2f}" for x in run) for run in v] for k, v in tm["host"].items()}
    phase(f"[12 tum] fps, {tm['fps_frames']} frames, alternating: run_tum on the Up directory "
          f"{' / '.join(f'{x:.2f}' for x in tm['fps']['tum_up'])}, on the adaptive directory "
          f"{' / '.join(f'{x:.2f}' for x in tm['fps']['tum_adaptive'])}, run_arrays "
          f"{' / '.join(f'{x:.2f}' for x in tm['fps']['arrays'])}; run_tum waited for the "
          f"loader on " + ", ".join(
              f"{k[4:]} " + " / ".join(f"{w['waits']} frames ({1e3 * w['wait_s']:.1f} ms)"
                                       for w in v) for k, v in tm["loader_waits"].items())
          + "; host ms a frame, wall / main thread CPU / process CPU: "
          + ", ".join(f"{k} {' and '.join(v)}" for k, v in host.items()))

    # ---- 13. the feature families on make_pipe -----------------------------
    n_sift, n_fam = min(SIFT_FRAMES, args.frames), min(FAMILY_FRAMES, args.frames)
    n_dtype = min(DTYPE_FRAMES, args.frames)
    torch.cuda.empty_cache()
    phase(f"[13 families] SIFTGPU ({n_sift} frames), BRISK and FREAK ({n_fam}) on make_pipe; "
          f"ORB with bf16 and float32 descriptor stores ({n_dtype})")
    fp = family_phase(poses, rgbs, depths, stamps, dev, ate_b[4], n_sift, n_fam, n_dtype)
    sr = fp["SIFTGPU"]
    sift_max = 1.5 * SIFT_L4_JAX
    st = sr["stats"]
    phase(f"[13 families] SIFTGPU at the reference's evaluation settings (600 features, 8 "
          f"candidates, RANSAC 100, ratio 0.9, RootSIFT) on make_pipe, {n_sift} frames: "
          f"{sr['fps']:.2f} fps over {n_sift - WARMUP} frames ({sr['ms_per_frame']:.2f} ms a "
          f"frame); ATE L0..L4 {' / '.join(f'{a:.4f}' for a in sr['ate'])} m (limit L4 <= "
          f"{sift_max:.4f} = 1.5 x the JAX package's "
          f"{SIFT_L4_JAX}); nodes {st['nodes']}, active edges {st['active_edges']} "
          f"({st['sequential_edges']} sequential, {sr['const_edges']} constant-position); "
          f"detect launches {sr['detect_launches']}, refine {sr['refine_launches']}, Kabsch "
          f"{sr['kabsch_launches']}; replays {sr['replays']}, synchronizing calls in "
          f"{sr['replay_groups']} replayed groups {sr['replay_syncs']}, waits that left the "
          f"card idle {sr['replay_idle']}; peak device memory {sr['peak_gib']:.2f} GiB "
          f"(descriptor store {sr['store_mib']:.1f} MiB)")
    eb, eby = sr["ext_bound"]
    phase(f"[13 families] SIFT extractor, one 640x480 frame, eager: device "
          f"{fmt_ms(sr['ext_ms'])} (profiler, mean of 20), {sr['ext_ops']} device activities; "
          f"bound {eb:.5f} ms ({eby}); the whole SIFT step a frame (a captured 4-frame group "
          f"replayed): device {fmt_ms(sr['step_ms'])}, {sr['step_ops']:.0f} device activities; "
          f"extractor share "
          + ("not measured" if not (sr["ext_ms"] and sr["step_ms"])
             else f"{sr['ext_ms'] / sr['step_ms']:.1%}"))
    eq = fp["sift_equal"]
    phase(f"[13 families] SIFTGPU 4 frames a step replayed ({eq['replays']} replays) vs 1 "
          f"frame a step eager, {eq['frames']} frames: max pose difference {eq['diff']:.3e} "
          f"(limit 0.0); statistics equal: {eq['stats_equal']}")
    for fam in ("BRISK", "FREAK"):
        r = fp[fam]
        phase(f"[13 families] {fam} (512 bits) on make_pipe, {n_fam} frames: {r['fps']:.2f} "
              f"fps; ATE L0..L4 {' / '.join(f'{a:.4f}' for a in r['ate'])} m (limit L4 <= "
              f"{fp['family_l4_max']:.4f} = max(2 x, +0.005 m) ORB's {ate_b[4]:.4f} in phase "
              f"6); active edges {r['stats']['active_edges']}; detect launches "
              f"{r['detect_launches']}, refine {r['refine_launches']}; synchronizing calls in "
              f"{r['replay_groups']} replayed groups {r['replay_syncs']}; peak device memory "
              f"{r['peak_gib']:.2f} GiB")
    phase(f"[13 families] ORB descriptor stores, one frame a step, eager, "
          f"{fp['dtype_frames']} frames: " + "; ".join(
              f"{d} ({v['dtype']}) max pose difference to int8 {v['diff']:.3e}, statistics "
              f"equal {v['stats_equal']}, {v['edges']} sequential edges"
              for d, v in fp["dtypes"].items()))
    launches_phase["sift"] = (sr["detect_launches"], sr["refine_launches"],
                              sr["kabsch_launches"])
    for fam in ("BRISK", "FREAK"):
        launches_phase[fam.lower()] = (fp[fam]["detect_launches"], fp[fam]["refine_launches"],
                                       fp[fam]["kabsch_launches"])
    if st["nodes"] != n_sift or not sr["poses_ok"] or not all(np.isfinite(sr["ate"])):
        fail(f"SIFTGPU: {st['nodes']} nodes for {n_sift} frames, ATE {sr['ate']}")
    if sr["ate"][4] > sift_max:
        fail(f"SIFTGPU: ATE L4 {sr['ate'][4]:.4f} m against the limit {sift_max}")
    if sr["detect_launches"] or sr["refine_launches"] != n_sift - 1 or sr["kabsch_launches"]:
        fail(f"SIFTGPU: launches detect {sr['detect_launches']}, refine "
             f"{sr['refine_launches']}, Kabsch {sr['kabsch_launches']}; expected 0, "
             f"{n_sift - 1}, 0")
    if not sr["replays"] or sr["replay_syncs"] or sr["replay_idle"]:
        fail(f"SIFTGPU: {sr['replays']} replays, {sr['replay_syncs']} syncs and "
             f"{sr['replay_idle']} idle waits in replayed groups")
    if not eq["replays"] or eq["diff"] != 0.0 or not eq["stats_equal"]:
        fail("SIFTGPU: the replayed groups differ from the eager steps")
    for fam in ("BRISK", "FREAK"):
        r = fp[fam]
        if (r["stats"]["nodes"] != n_fam or not r["poses_ok"] or not all(np.isfinite(r["ate"]))
                or r["ate"][4] > fp["family_l4_max"]):
            fail(f"{fam}: {r['stats']['nodes']} nodes, ATE {r['ate']} against L4 <= "
                 f"{fp['family_l4_max']:.4f}")
        if r["detect_launches"] != n_fam or r["refine_launches"] != n_fam - 1:
            fail(f"{fam}: launches detect {r['detect_launches']}, refine "
                 f"{r['refine_launches']} for {n_fam} frames")
        if r["replay_syncs"] or r["replay_idle"]:
            fail(f"{fam}: {r['replay_syncs']} syncs, {r['replay_idle']} idle waits in "
                 f"replayed groups")
    for d, v in fp["dtypes"].items():
        if v["diff"] != 0.0 or not v["stats_equal"]:
            fail(f"descriptor store {d}: poses differ from int8's by {v['diff']:.3e}, "
                 f"statistics equal {v['stats_equal']}")

    # ---- 14. the device step's remaining options ------------------------
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[14 options] make_pipe on the bench orbit (native encode), one run an option as "
          f"phase 6 drives it; L4 bound max(1.5 x, + 5 mm) the JAX package's on the same "
          f"frames (mean of its seeds 0-3, OPTIONS)")
    op = options_phase(poses, rgbs, depths, stamps, dev, args.frames)
    report_options(op, args.frames)
    launches_phase.update({f"option_{k}": (op[k][0]["detect_launches"],
                                           op[k][0]["refine_launches"],
                                           op[k][0]["kabsch_launches"])
                           for k in [*OPTIONS, "default"]})

    # ---- 15. the bag and cloud inputs, batch evaluation, F22 --------------
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[15 bag] the bench frames through the bag and point-cloud inputs (make_pipe, "
          f"the rgbdslam-torch CLI), batch evaluation over phase 12's TUM directories, and "
          f"3 frames a step")
    bp = bag_phase(poses, rgbs, depths, stamps, dev, Path(work.name))
    nb, st = bp["bag_frames"], bp["stats"]
    phase(f"[15 bag] {nb} frames written as a ROS bag (rgb8 + 32FC1 meters, /tf ground truth "
          f"as /kinect, uncompressed chunks): {bp['bag_mib']:.1f} MiB in "
          f"{bp['bag_write_s']:.2f} s; pairing the bag {bp['pair_s']:.3f} s; decode "
          f"{bp['decode_ms']:.2f} ms a frame (RGB + depth, {BAG_DECODE_FRAMES} frames, equal "
          f"to the written frames)")
    phase(f"[15 bag] rgbdslam-torch run --bagfile --evaluate --save-bag -p "
          f"ground_truth_frame_name=/kinect, make_pipe: ATE L0..L4 "
          f"{' / '.join(f'{a:.4f}' for a in bp['ate'])} m (against the rendered poses "
          f"within {bp['ate_diff']:.1e} m; run_arrays on the same frames: L4 "
          f"{bp['ref_l4']:.4f} m); nodes {st['nodes']}, active "
          f"edges {st['active_edges']}; detect launches {bp['launches'][0]}, refine "
          f"{bp['launches'][1]}, Kabsch {bp['launches'][2]}; against run_arrays on the same "
          f"frames: trajectory files L0..L4 {' / '.join(f'{d:.1e}' for d in bp['traj_diff'])} "
          f"(limit 1e-5); result.bag positions within {bp['result_bag_diff']:.1e} m; whole "
          f"command {bp['cli_s']:.1f} s; synchronizing calls in {bp['replay_groups']} "
          f"replayed groups {bp['replay_syncs']}")
    phase(f"[15 bag] fps, {nb} frames, alternating: run_bag "
          f"{' / '.join(f'{x:.2f}' for x in bp['fps']['bag'])} (pairing included), run_arrays "
          f"{' / '.join(f'{x:.2f}' for x in bp['fps']['arrays'])}")
    phase(f"[15 bag] {bp['pcd_frames']} frames as organized binary PCDs (NaN rows for "
          f"invalid depth): {bp['pcd_mib']:.1f} MiB, written {bp['pcd_write_ms']:.1f} ms a "
          f"frame; load + cloud_to_rgbd {bp['pcd_load_ms']:.2f} ms a frame, depth bitwise and "
          f"colours equal; rgbdslam-torch run --pcd-dir --evaluate, make_pipe: detect "
          f"launches {bp['pcd_launches'][0]}, refine {bp['pcd_launches'][1]}; against "
          f"run_arrays: trajectory files L0..L4 "
          f"{' / '.join(f'{d:.1e}' for d in bp['pcd_traj_diff'])} (limit 1e-5); whole command "
          f"{bp['pcd_cli_s']:.1f} s")
    phase(f"[15 bag] evaluate_sequences on the card, 2 TUM directories x 2 configurations, "
          f"{EVAL_FRAMES} frames each, in {bp['batch_s']:.1f} s: " + "; ".join(
              f"{name}/{cfg} L4 {l4:.4f} m, {fps:.2f} fps, {nodes} nodes"
              for name, cfg, l4, fps, nodes in bp["batch"])
          + f"; summary.csv header + 4 rows; detect launches {bp['batch_launches'][0]}, "
          f"refine {bp['batch_launches'][1]}")
    f22 = bp["f22"]
    phase(f"[15 bag] tpu_frames_per_step=3 (F22), {f22['frames']} frames in chunks "
          f"{'/'.join(map(str, F22_CHUNKS))}: group lengths {f22['lengths']}, replayed groups "
          f"by length {f22['replayed']} of {f22['groups']}, CUDA graphs captured "
          f"{f22['captures']}, replays {f22['replays']}; against 1 frame a step eager: max "
          f"pose difference {f22['diff']:.3e} (limit 1e-6), statistics equal "
          f"{f22['stats_equal']}; synchronizing calls in replayed groups "
          f"{f22['replay_syncs']}, idle waits {f22['replay_idle']}")
    launches_phase.update(bag=bp["launches"], pcd=bp["pcd_launches"],
                          batch_eval=bp["batch_launches"], frames_per_step_3=bp["f22_launches"])

    # ---- 16. retrieval, odometry, landmark BA, covariances, stereo, mesh --
    del bp
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[16 retrieval] make_pipe with global_loop_candidates=2 on the bench orbit, as "
          f"phase 6 drives it; the default path with retrieval and with ground-truth "
          f"odometry; landmark BA and empirical covariances; the stereo input and the mesh")
    work16 = tempfile.TemporaryDirectory()
    p16 = phase16(poses, rgbs, depths, stamps, dev, Path(work16.name))
    work16.cleanup()
    report_phase16(p16, args.frames)
    r16 = p16["run"]
    launches_phase.update(
        retrieval=(r16["detect_launches"], r16["refine_launches"], r16["kabsch_launches"]),
        default_retrieval=p16["host"]["launches"],
        odometry_only=p16["odometry"]["only"]["launches"],
        odometry_visual=p16["odometry"]["visual"]["launches"],
        stereo=p16["stereo"]["launches"])

    # ---- 17. many sequences at once: slam-multi, vo-multi, the mesh -------
    del p16
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[17 multi] ROADMAP item 28: {MULTI_S} sequences of full SLAM in lockstep "
          f"(parallel/slam_multi.py), sequences 0 and 7 alone, replay = eager, "
          f"a 2-shard mesh, the sharded compare and LM, vo-multi, and the slam-multi CLI")
    p17 = phase17(dev, [Path(work.name) / "tum", Path(work.name) / "tum_adaptive"],
                  Path(work.name), min(MULTI_FRAMES, args.frames))
    report_phase17(p17, smi_line)
    launches_phase.update(slam_multi=p17["launches"], vo_multi=p17["vo_launches"])

    # ---- 18. the live viewer and the run controls: run --serve, view, serve
    del p17
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"[18 serve] ROADMAP item 27b: rgbdslam-torch run --serve on phase 12's Up "
          f"directory, driven over HTTP (pause, step, save, param), against the same run "
          f"stepped eagerly; view --html and serve; fps with the live view on and off; the "
          f"step's stages against the roofline")
    p18 = phase18(dev, Path(work.name) / "tum", Path(work.name))
    work.cleanup()  # phase 12's TUM directories served phases 15, 17 and 18
    report_phase18(p18, smi_line)
    launches_phase["serve"] = p18["param"]["launches"]

    phase(f"[done] total {time.perf_counter() - t_start:.1f} s; {phase_seconds()}")
    (dk, ek), (dp, ep) = times["frame"], times["frame_plain"]
    bound, by = times["frame_bound"]
    phase(json.dumps({"kernels": [{
        "name": "detect_corners",
        "route": "cuda",
        "source": "rgbdslam_v2_tpu_torch/csrc/detect_corners.cu",
        "replaces": "rgbdslam_v2_tpu/ops/pallas_detect.py:122",
        "launches": launches_bench,
        "launches_per_frame": launches_bench / args.frames,
        "launches_keepall_one_frame_a_step": launches,
        "launches_default": launches_default,
        "launches_per_frame_default": launches_default / n_default_frames,
        **{f"launches_{k}": v[0] for k, v in launches_phase.items()},
        "max_abs_err": max_abs,
        # one frame's four levels, profiler device time (null where the trace
        # held no device activity; the event spans below include the host)
        "ms": dk,
        "plain_ms": dp,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes FAST-9 + Harris + NMS
        "event_ms": ek,
        "plain_event_ms": ep,
        "level0_ms": times["level0"][0],
        "level0_bound_ms": times["level0_bound"][0],
        "stage_ms": stage,
    }, {
        "name": "weighted_kabsch",
        "route": "cuda",
        "source": "rgbdslam_v2_tpu_torch/csrc/kabsch.cu",
        "replaces": "rgbdslam_v2_tpu/core/alignment.py:18",
        # 0 on every path: the step's refits run in ransac_refine now; the
        # kernel stays for weighted_kabsch's other callers (Horn alignment)
        "main_path": False,
        "launches": kab_launches_bench,
        "launches_per_frame": kab_launches_bench / (args.frames - 1),
        "launches_keepall_one_frame_a_step": kab_launches_keepall,
        "launches_default": kab_launches_default,
        **{f"launches_{k}": v[2] for k, v in launches_phase.items()},
        "max_abs_err": kab_err,
        # one refit of the main path: 8 problems of 300 points
        "ms": kab_times["kernel"][0],
        "plain_ms": kab_times["plain"][0],
        "bound_ms": kab_bound,
        "bound_by": kab_by,
        # torch.linalg.svd + det of the same 8 cross-covariances
        "library_ms": kab_times["library"][0],
        "event_ms": kab_times["kernel"][1],
        "plain_event_ms": kab_times["plain"][1],
        "library_event_ms": kab_times["library"][1],
    }, {
        "name": "ransac_refine",
        "route": "cuda",
        "source": "rgbdslam_v2_tpu_torch/csrc/kabsch.cu",
        "replaces": "rgbdslam_v2_tpu/ops/registration.py:262",
        "launches": ref_launches_bench,
        "launches_per_frame": ref_launches_bench / (args.frames - 1),
        "launches_keepall_one_frame_a_step": ref_launches_keepall,
        "launches_default": ref_launches_default,
        **{f"launches_{k}": v[1] for k, v in launches_phase.items()},
        "max_abs_err": ref_err,
        # one frame's refinement: 8 candidates x 300 matches, 4 refits
        "ms": ref_times["kernel"][0],
        "plain_ms": ref_times["plain"][0],
        "bound_ms": ref_bound,
        "bound_by": ref_by,
        "library_ms": None,  # no single PyTorch call computes the refit-and-gate loop
        "old_route_ms": ref_times["old_route"][0],  # 4 Kabsch launches + the torch gate ops
        "old_route_device_ops": old_ops,
        "event_ms": ref_times["kernel"][1],
        "plain_event_ms": ref_times["plain"][1],
        "old_route_event_ms": ref_times["old_route"][1],
    }, {
        "name": "ransac_refine (projective_iterations=3)",
        "route": "cuda",
        "source": "rgbdslam_v2_tpu_torch/csrc/kabsch.cu",
        "replaces": "rgbdslam_v2_tpu/ops/projective.py:59",
        # phase 14's g2o_transformation_refinement=3 runs with RANSAC seed 0
        # (make_pipe and default_params()); the stage's launch is the refine
        # kernel's
        "launches": op["g2o_refinement"][0]["refine_launches"],
        "launches_per_frame": op["g2o_refinement"][0]["refine_launches"]
        / (op["g2o_refinement"][0]["frames"] - 1),
        "launches_default": op["default"][0]["refine_launches"],
        "max_abs_err": proj_err,
        # one frame's refinement: 8 candidates x 300 matches, 4 refits, 3
        # projective iterations
        "ms": proj_times["kernel"][0],
        "plain_ms": proj_times["plain"][0],
        "bound_ms": proj_bound,
        "bound_by": proj_by,
        "library_ms": None,  # no single PyTorch call computes the GN alternation
        "event_ms": proj_times["kernel"][1],
        "plain_event_ms": proj_times["plain"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
