"""stereo_visual_slam — a stereo visual SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++/ROS system (shangzhouye/stereo-visual-slam): ORB front-end (oriented FAST +
rBRIEF), stereo depth, Hamming matching, PnP-RANSAC motion estimation, sliding
window keyframe/landmark map, and Levenberg-Marquardt bundle adjustment with
Schur-complement reduction — all as fixed-shape, jit-compiled array programs,
with a `parallel/` layer that shards bundle adjustment over a device mesh.

Layout (mirrors SURVEY.md §7 build plan):
  geom/      SE(3)/SO(3) Lie group core
  ops/       front-end kernels (FAST, ANMS, rBRIEF, Hamming matcher, stereo)
  ops/pallas Pallas GPU kernel (Triton route) for the FAST score map
  models/    the flagship per-frame frontend+tracking step as one jitted fn
  tracking/  vectorized RANSAC PnP + robust Gauss-Newton pose refinement
  mapping/   keyframe/landmark map store (host bookkeeping, device payloads)
  ba/        LM + Schur bundle adjustment, pose-only variant
  parallel/  multi-device distributed BA (shard_map + psum over a Mesh)
  pipeline/  tracking state machine, BA schedule, trajectory IO, KITTI eval
  data/      KITTI odometry reader + synthetic stereo sequence generator
  utils/     config (all reference constants), profiling, logging
"""

__version__ = "0.1.0"

from stereo_visual_slam.utils.config import Config  # noqa: F401
