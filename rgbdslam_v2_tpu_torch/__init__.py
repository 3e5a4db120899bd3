"""rgbdslam_v2_tpu_torch — the PyTorch/CUDA port of rgbdslam_v2_tpu.

Same layering and module names as the JAX package (``rgbdslam_v2_tpu``),
which stays the reference: every module here names its JAX counterpart in
its docstring. This package imports torch and numpy, never jax. Its entry
points run on the CUDA card unless the caller passes device="cpu".

  core/      SE(3) geometry, pinhole camera, frames, depth noise, rigid
             alignment
  ops/       image ops, FAST/Harris detection (hand-written CUDA kernel in
             csrc/), ORB description, matching, RANSAC, EMM
  models/    OrbExtractor and the Keypoints container
  ops/icp    dense GICP / point-to-plane ICP (torch ops)
  graph/     ingest wire, node store, candidate compare, per-frame step,
             GraphManager (keep-all fast path and host-decision path),
             the ICP rescues, host bookkeeping and decisions, the g2o
             writer and reader
  optim/     LM pose-graph optimization (dense and PCG solvers)
  mapping/   the colour voxel map (ray-walk insert on the device) and the
             OctoMap .ot writer
  pipeline/  SlamPipeline (arrays or a TUM directory), the output writers
             and the 5-level evaluation protocol
  eval/      ATE, RPE, Wilcoxon comparison
  io/        TUM datasets (a PNG codec of its own with a C++ row
             unfilter, a threaded loader) and trajectories, PCD/PLY
             clouds, the synthetic worlds' renderer (hard sequences
             included), the native host wire encoder
  config/    parameter server (same names as the JAX package)
  apps/      the rgbdslam-torch command line (run, synthetic, ate, rpe,
             params)
"""

__version__ = "0.1.0"
