"""Single source of truth for every semantic constant of the pipeline.

The reference hard-codes these across many files (catalogued in SURVEY.md §5
"Config / flag system"); here they are all named fields with the reference's
values as defaults.  Citations point into /root/reference.

Shapes (n_features, window size, landmark capacity, hypothesis count, image
padding) are *static* — they fix every array shape in the jitted pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole stereo intrinsics.

    Defaults = KITTI odometry seq 00-02 grayscale rig, hard-coded in the
    reference at run_vslam.cpp:34-35 and duplicated in types_def.hpp:53-54.
    """

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 0.573  # metres (types_def.hpp:54)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Feature detection / description / stereo depth.

    Reference: cv::ORB::create(3000) (visual_odometry.cpp:22), ANMS to 500
    (visual_odometry.cpp:82), SGBM disparity 0..96 (visual_odometry.cpp:163),
    depth gates 10/40/400 m (visual_odometry.cpp:194,201).
    """

    # Detection. The reference caps raw ORB corners at 3000
    # (visual_odometry.cpp:22); 2048 measured equal-or-better on the
    # synthetic benchmark (ate 0.114 vs 0.125) while shrinking the matcher's
    # NxN distance matrix 2.1x. Set 3000 to mirror the reference cap.
    max_raw_keypoints: int = 2048      # ORB cap before ANMS (all levels)
    n_features: int = 500              # ANMS target (fixed feature array size)
    # Image pyramid (cv::ORB defaults: 8 levels, 1.2 scale factor).
    # Keypoint budget per level falls geometrically (1/scale_factor).
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20           # FAST-9/16 intensity threshold
    fast_arc_length: int = 9           # contiguous circle pixels required
    nms_radius: int = 1                # 3x3 non-max suppression
    border_margin: int = 20            # keep keypoints away from image edge
    anms_robust_coeff: float = 1.11    # visual_odometry.cpp:120
    # Description
    patch_size: int = 33               # extracted patch (rBRIEF radius 15 + bilinear margin)
    orientation_radius: int = 15       # intensity-centroid circle radius
    descriptor_bits: int = 256         # rBRIEF length
    blur_box: int = 5                  # 5x5 box blur before sampling (BRIEF standard)
    # Upright vs orientation-steered BRIEF. The reference steers
    # (cv::ORB rBRIEF); on roll-free rigs (KITTI) the centroid angle is
    # noise on weak corners and steering HALVES the true-match rate while
    # costing a 30x larger matmul — see ops/orb.py describe(). Set True for
    # rotation-invariant matching.
    steer_descriptor: bool = False
    # Stereo depth (per-keypoint epipolar search replaces dense SGBM)
    max_disparity: int = 96            # visual_odometry.cpp:164 numDisparities
    stereo_patch: int = 11             # SGBM block size 9 -> use 11 ZNCC window
    min_zncc: float = 0.6              # match acceptance score
    min_depth: float = 10.0            # visual_odometry.cpp:194
    max_depth: float = 400.0           # visual_odometry.cpp:194
    reliable_depth: float = 40.0       # visual_odometry.cpp:201
    # Compute stereo depth lazily inside the chunk program's keyframe branch
    # (frontend.make_depth_stage) instead of for every frame in the batch
    # extractor: depth is only read at keyframe insertion (the reference
    # also recomputes disparity only there, visual_odometry.cpp:377), so
    # this cuts the ~1.5 ms/frame sweep to the keyframe fraction.
    # Bit-identical results either way.
    lazy_depth: bool = True


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Brute-force Hamming with cross-check and the reference distance gate:
    keep matches with d <= max(2*min_d, 30*frame_gap) (visual_odometry.cpp:239-246).
    """

    # The reference's base gate is 30 Hamming bits/frame-gap on OpenCV's
    # learned rBRIEF (visual_odometry.cpp:242). Our upright random-pattern
    # BRIEF runs hotter on true matches; 45 measured best on the synthetic
    # benchmark (trans 0.74% vs 0.85% @30, rot 0.0091 vs 0.0170 deg/m) —
    # junk admitted by the wider gate is rejected by PnP RANSAC.
    base_gate: float = 45.0
    min_dist_factor: float = 2.0
    # robustness additions (see ops/matcher.py): absolute-margin ratio test
    # (0 disables) and motion-prediction search radius (px, scaled by frame
    # gap). Swept on the synthetic benchmark: radius 60 with no margin gives
    # the best inlier count (ambiguous silhouette matches are excluded
    # geometrically rather than by descriptor distinctiveness).
    margin: float = 0.0
    search_radius: float = 60.0


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """Motion estimation, mirroring cv::solvePnPRansac(100, 4.0, 0.99)
    (visual_odometry.cpp:277) with a vectorized hypothesis batch.
    """

    n_hypotheses: int = 128            # reference: 100 RANSAC iterations
    sample_size: int = 4               # minimal set per hypothesis
    inlier_px: float = 4.0             # reprojection error threshold
    gn_iters_hypothesis: int = 10      # GN iterations per minimal set
    gn_iters_refine: int = 10          # robust refinement on inliers
    huber_px: float = 4.0              # Huber scale for the refinement
    min_inliers: int = 10              # check_motion_estimation (visual_odometry.cpp:319)
    max_twist: float = 5.0             # ||log(T_c_l)|| <= 5 * frame_gap (visual_odometry.cpp:329)
    # hypothesis-start diversity (tracking/pnp.py): translation std of the
    # perturbed half of the RANSAC starts, per unit frame gap. Plays the
    # prior-independence role of the reference's closed-form minimal solves.
    prior_spread: float = 0.3


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe insertion rule: insert unless (inliers >= 80 and |angleY| < 0.03)
    (visual_odometry.cpp:353); sliding window of 10 (map.hpp:22); eviction
    closest-if-<0.2-else-farthest (map.cpp:48-130)."""

    min_inliers_skip: int = 80
    max_yaw_skip: float = 0.03
    window_size: int = 10
    eviction_min_dist: float = 0.2
    max_lost: int = 10                 # consecutive failures -> Lost (visual_odometry.cpp:663)


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment. chi2 threshold 5.991 and Huber delta 5.991 from
    optimization.cpp:154,205; adaptive doubling loop optimization.cpp:224-252;
    schedule from run_vslam.cpp:58-71."""

    # Master switch for the whole per-keyframe schedule. False reproduces
    # the reference's "Without Optimization" row (README.md:92-94): no LM
    # passes, no adaptive chi2 classification, landmark inlier flags
    # untouched. (Zeroing the iteration counts instead would still run the
    # classification and flip is_inlier — not what that row means.)
    enable_ba: bool = True
    chi2_threshold: float = 5.991
    huber_delta: float = 5.991         # g2o rk->setDelta(5.991): kernel on ||r||
    adaptive_rounds: int = 5
    target_inlier_ratio: float = 0.5
    # LM damping
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.5
    lm_lambda_min: float = 1e-10
    lm_lambda_max: float = 1e8
    # Schedule. The reference runs 2 classify passes @5 iters, pose update
    # @10, pose-only @10 (run_vslam.cpp:61-70). With warm-started windows
    # and early exit (rel_tol below) the extra iterations are no-ops —
    # these maxima measure bit-identical trajectory error on the synthetic
    # benchmark with fewer LM iterations per keyframe. Use
    # `reference_ba_schedule()` for the exact reference counts.
    classify_iters: int = 2
    classify_passes: int = 1
    full_iters: int = 5
    pose_only_iters: int = 3
    # Early exit: stop once an accepted LM step improves cost by < rel_tol
    # (iteration counts above become MAXIMA; warm-started windows converge
    # in 1-3 iterations). Step-direction matmuls run at `matmul_precision`
    # ("default" lets the GPU use TF32 for f32 matmuls) while residuals and
    # costs stay exact f32 — see ba/schur_lm.py docstring.
    rel_tol: float = 1e-6
    matmul_precision: str = "default"
    # Capacities (static shapes)
    max_landmarks: int = 4096          # padded landmark table (10 kf x 500 feats)
    fix_oldest_pose: bool = True       # gauge anchor (reference relies on LM damping
                                       # alone, optimization.cpp:127-140 sets no vertex
                                       # fixed; anchoring improves conditioning)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config. `image_hw` is the unpadded input size (KITTI seq 00:
    370-376 x 1226-1241); images are padded to `padded_hw`, multiples of
    128, for static shapes."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    keyframe: KeyframeConfig = dataclasses.field(default_factory=KeyframeConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)

    image_hw: Tuple[int, int] = (376, 1241)

    @property
    def padded_hw(self) -> Tuple[int, int]:
        h, w = self.image_hw
        return (-(-h // 128) * 128, -(-w // 128) * 128)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = Config()


def reference_ba_schedule(cfg: BAConfig | None = None) -> BAConfig:
    """The exact BA iteration budget of the reference (run_vslam.cpp:61-70):
    2 classify passes @5, full BA @10, pose-only @10. Early exit still
    applies; disable it with rel_tol=0 for strict fixed-count behavior."""
    return dataclasses.replace(
        cfg or BAConfig(),
        classify_passes=2,
        classify_iters=5,
        full_iters=10,
        pose_only_iters=10,
    )


def small_config(h: int = 128, w: int = 256) -> Config:
    """A reduced config for unit tests / CI on CPU: smaller images + tables."""
    c = Config(image_hw=(h, w))
    return c.replace(
        frontend=dataclasses.replace(
            c.frontend, max_raw_keypoints=512, n_features=128,
            max_disparity=32, n_levels=3,
        ),
        ba=dataclasses.replace(c.ba, max_landmarks=512),
        pnp=dataclasses.replace(c.pnp, n_hypotheses=64),
    )
