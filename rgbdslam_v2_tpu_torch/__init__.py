"""rgbdslam_v2_tpu_torch — the PyTorch/CUDA port of rgbdslam_v2_tpu.

Same layering and module names as the JAX package (``rgbdslam_v2_tpu``),
which stays the reference: every module here names its JAX counterpart in
its docstring. This package imports torch and numpy, never jax. Its entry
points run on the CUDA card unless the caller passes device="cpu".

  core/      SE(3) geometry, pinhole camera, depth noise, rigid alignment
  ops/       image ops, FAST/Harris detection (hand-written CUDA kernel in
             csrc/), ORB description, matching, RANSAC, EMM
  models/    OrbExtractor and the Keypoints container
  ops/icp    dense GICP / point-to-plane ICP (torch ops)
  graph/     ingest wire, node store, candidate compare, per-frame step,
             GraphManager (keep-all fast path and host-decision path),
             the ICP rescues, host bookkeeping and decisions
  optim/     LM pose-graph optimization (dense and PCG solvers)
  pipeline/  SlamPipeline and the 5-level evaluation protocol
  eval/      ATE, RPE, Wilcoxon comparison
  io/        TUM trajectory I/O, the synthetic worlds' renderer (hard
             sequences included), the native host wire encoder
  config/    parameter server (same names as the JAX package)
"""

__version__ = "0.1.0"
