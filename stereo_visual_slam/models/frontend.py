"""Per-frame feature extraction: one jitted function, fixed shapes.

Fuses the reference's per-frame front-end sequence — feature_detection
(visual_odometry.cpp:70-94), ANMS (:96-157), descriptor compute (:85),
disparity (:159-174) and 3D gating (:176-217) — into a single XLA program:
padded image in, padded feature table out. No host round-trips inside.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_visual_slam.ops import anms as anms_ops
from stereo_visual_slam.ops import fast as fast_ops
from stereo_visual_slam.ops import image as im_ops
from stereo_visual_slam.ops import orb as orb_ops
from stereo_visual_slam.ops import stereo as stereo_ops
from stereo_visual_slam.ops.pallas import fast_kernel
from stereo_visual_slam.utils.config import Config
from stereo_visual_slam.utils.hostconst import build_on_host


class FrameFeatures(NamedTuple):
    """Fixed-size feature table for one stereo frame.

    N = config max_raw_keypoints: descriptors and stereo depth are computed
    for ALL raw FAST corners (the matcher searches everything — detection
    repeatability over the raw set is ~80% vs ~52% for an ANMS subset, and
    the extra compute is small next to the matcher's matmul). `spawn_mask`
    marks the ANMS-selected uniform subset (config n_features strong) used to spawn
    NEW features at keyframes, preserving the reference's ANMS-500 behavior
    (visual_odometry.cpp:82).

    Multi-scale: keypoints come from an n_levels / scale_factor image
    pyramid (cv::ORB defaults 8 / 1.2, visual_odometry.cpp:22). `yx` is in
    FULL-RES pixels (float32 — level coords x scale, sub-pixel on coarse
    levels); `scale` is the per-keypoint level scale (1.2^level). The
    descriptor is computed on the keypoint's own pyramid level."""

    yx: jnp.ndarray          # (N, 2) float32 FULL-RES keypoint coords (row, col)
    score: jnp.ndarray       # (N,) FAST response (at the detection level)
    scale: jnp.ndarray       # (N,) f32 — scale_factor**level
    valid: jnp.ndarray       # (N,) bool — detected keypoint
    spawn_mask: jnp.ndarray  # (N,) bool — ANMS-selected subset
    signs: jnp.ndarray       # (N, 256) {-1,+1} descriptor for matmul matching
    packed: jnp.ndarray      # (N, 8) uint32 packed descriptor
    disparity: jnp.ndarray   # (N,) f32
    depth: jnp.ndarray       # (N,) f32 camera-frame z
    depth_valid: jnp.ndarray  # (N,) bool — 10 m < z < 400 m and good match
    reliable: jnp.ndarray    # (N,) bool — z < 40 m
    pts_cam: jnp.ndarray     # (N, 3) camera-frame 3D (valid where depth_valid)


def _fast_nms(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """NMS'd FAST score map. Lowered for the GPU, the score map is the
    Triton-route Pallas kernel (ops/pallas/fast_kernel.py); on every other
    platform it is the XLA formulation (ops/fast.py), which the kernel
    equals bit for bit."""
    score = jax.lax.platform_dependent(
        img,
        cuda=lambda im: fast_kernel.fast_score_map(im, threshold),
        default=lambda im: fast_ops.fast_score_map(im, threshold),
    )
    return fast_ops.nms_3x3(score)


def _describer(fe):
    """BRIEF at integer keypoints of one blurred level image."""
    return functools.partial(
        orb_ops.describe, bits=fe.descriptor_bits, patch=fe.patch_size,
        steer=fe.steer_descriptor,
    )


def _level_geometry(config: Config):
    """Static per-level geometry: (scale, valid (h, w), padded (H, W),
    keypoint budget). Budgets follow cv::ORB's geometric distribution
    (factor 1/scale per level, visual_odometry.cpp:22 defaults)."""
    fe = config.frontend
    vh, vw = config.image_hw
    sf = fe.scale_factor
    n = fe.n_levels
    inv = [sf ** -i for i in range(n)]
    total = sum(inv)
    budgets = [int(fe.max_raw_keypoints * w / total) for w in inv]
    budgets[0] += fe.max_raw_keypoints - sum(budgets)

    def pad_up(x, q):
        return -(-x // q) * q

    out = []
    for i in range(n):
        s = sf ** i
        h_i, w_i = (vh, vw) if i == 0 else (round(vh / s), round(vw / s))
        # level 0 is the padded input; coarser levels pad to even sizes,
        # which the lossless 2x2-pooled top-k needs (ops/fast.nms_topk)
        padded = (
            config.padded_hw if i == 0 else (pad_up(h_i, 2), pad_up(w_i, 2))
        )
        out.append((s, (h_i, w_i), padded, budgets[i]))
    return out


@build_on_host
def make_extractor(config: Config):
    """Build the jitted extractor closed over static config.

    Pyramid flow per level: bilinear-downscale the valid region, FAST+NMS+
    top-k_i, blur, BRIEF at level resolution. Levels merge
    into one N-row table with full-res float coords and per-row scale;
    stereo depth runs once at full resolution on the merged table (disparity
    accuracy is resolution-bound, not scale-bound)."""
    fe = config.frontend
    cam = config.camera
    vh, vw = config.image_hw
    levels = _level_geometry(config)

    describe = _describer(fe)

    @jax.jit
    def extract(left: jnp.ndarray, right: jnp.ndarray) -> FrameFeatures:
        """left/right: (H, W) padded f32 grayscale."""
        yx_parts, yxf_parts, score_parts, scale_parts = [], [], [], []
        packed_parts, signs_parts = [], []
        for i, (s, (h_i, w_i), (H_i, W_i), budget) in enumerate(levels):
            if i == 0:
                img = left
            else:
                img = jax.image.resize(
                    left[:vh, :vw], (h_i, w_i), method="linear"
                )
                img = im_ops.pad_to(img, (H_i, W_i))
            score = fast_ops.mask_border(
                _fast_nms(img, fe.fast_threshold), (h_i, w_i),
                fe.border_margin,
            )
            score_i, yx_i = fast_ops.nms_topk(score, budget)
            blurred = im_ops.box_blur(img, fe.blur_box)
            packed_i, signs_i, _theta = describe(blurred, yx_i)
            yx_full = yx_i.astype(jnp.float32) * s
            yx_parts.append(jnp.round(yx_full).astype(jnp.int32))
            yxf_parts.append(yx_full)
            score_parts.append(score_i)
            scale_parts.append(jnp.full((budget,), s, jnp.float32))
            packed_parts.append(packed_i)
            signs_parts.append(signs_i)

        yx_int = jnp.concatenate(yx_parts)        # (N, 2) full-res int
        yx_f = jnp.concatenate(yxf_parts)         # (N, 2) full-res float
        score = jnp.concatenate(score_parts)
        scale = jnp.concatenate(scale_parts)
        packed = jnp.concatenate(packed_parts)
        signs = jnp.concatenate(signs_parts)

        valid = score > 0.0
        # keep full-res coords in the valid image (rounding can push a
        # border keypoint of a coarse level slightly out)
        valid = valid & (yx_int[:, 0] < vh) & (yx_int[:, 1] < vw)
        spawn_mask = anms_ops.anms_mask(
            yx_int, score, num=fe.n_features, robust_coeff=fe.anms_robust_coeff
        )
        st = stereo_ops.match_disparity(
            left,
            right,
            yx_int,
            valid,
            fx=cam.fx,
            baseline=cam.baseline,
            max_disparity=fe.max_disparity,
            patch=fe.stereo_patch,
            min_zncc=fe.min_zncc,
            min_depth=fe.min_depth,
            max_depth=fe.max_depth,
            reliable_depth=fe.reliable_depth,
        )
        pts_cam = stereo_ops.backproject(
            yx_f, st.depth, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy
        )
        return FrameFeatures(
            yx=yx_f,
            score=score,
            scale=scale,
            valid=valid,
            spawn_mask=spawn_mask,
            signs=signs,
            packed=packed,
            disparity=st.disparity,
            depth=st.depth,
            depth_valid=st.valid,
            reliable=st.reliable,
            pts_cam=pts_cam,
        )

    return extract


@build_on_host
def make_depth_stage(config: Config):
    """Per-frame stereo depth as a standalone stage: (image (2, H, W),
    feats) -> dict of the five FrameFeatures depth fields.

    Tracking never reads depth — only keyframe insertion does (spawn /
    upgrade, visual_odometry.cpp:377-401) — so the production chunk program
    computes it lazily inside the keyframe branch (26 % of frames at the
    production mix) instead of for every frame in the batch extractor.
    Bit-identical to the eager fields: same match_disparity/backproject on
    the same rounded coords (the batched stereo sweep is per-keypoint
    independent).
    """
    fe = config.frontend
    cam = config.camera

    def depth_stage(image: jnp.ndarray, feats: FrameFeatures) -> dict:
        left = image[0].astype(jnp.float32)
        right = image[1].astype(jnp.float32)
        yx_int = jnp.round(feats.yx).astype(jnp.int32)
        st = stereo_ops.match_disparity(
            left,
            right,
            yx_int,
            feats.valid,
            fx=cam.fx,
            baseline=cam.baseline,
            max_disparity=fe.max_disparity,
            patch=fe.stereo_patch,
            min_zncc=fe.min_zncc,
            min_depth=fe.min_depth,
            max_depth=fe.max_depth,
            reliable_depth=fe.reliable_depth,
        )
        pts_cam = stereo_ops.backproject(
            feats.yx, st.depth, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy
        )
        return dict(
            disparity=st.disparity,
            depth=st.depth,
            depth_valid=st.valid,
            reliable=st.reliable,
            pts_cam=pts_cam,
        )

    return depth_stage


@build_on_host
def make_batch_extractor(config: Config, with_depth: bool = True):
    """Batched extractor: (B, 2, H, W) images -> FrameFeatures with a leading
    B axis — bit-identical per frame to `make_extractor` (tests assert it).

    `with_depth=False` skips the stereo sweep and backprojection (fields
    zeroed) for pipelines that compute depth lazily at keyframes via
    `make_depth_stage` (the production chunk program).

    This is the production front-end of the chunked SLAM core: extraction is
    per-frame independent, so the chunk's B frames run as ONE batched program
    *outside* the sequential tracking scan (models/slam_core.make_chunk_step)
    instead of B serialized copies inside it. Besides utilization, this is
    the data-parallel axis over a mesh (each device extracts B/n frames).

    Batching strategy per op (keeping per-frame bit-exactness):
      * FAST + NMS and the stereo ZNCC sweep run on the B frames STACKED
        vertically into one (B*H, W) image — the FAST kernel needs no
        batch rule, and scores within `border_margin` of frame seams (the
        only pixels whose neighborhoods cross frames) are masked off before
        top-k exactly as image borders already are.
      * describe/ANMS/resize are vmapped.
    """
    fe = config.frontend
    cam = config.camera
    vh, vw = config.image_hw
    levels = _level_geometry(config)
    border = fe.border_margin

    describe = _describer(fe)

    @jax.jit
    def batch_extract(images: jnp.ndarray) -> FrameFeatures:
        """images: (B, 2, H, W) uint8/f32 padded stereo pairs."""
        B = images.shape[0]
        left = images[:, 0].astype(jnp.float32)    # (B, H, W)
        right = images[:, 1].astype(jnp.float32)

        yx_parts, yxf_parts, score_parts, scale_parts = [], [], [], []
        packed_parts, signs_parts = [], []
        for i, (s, (h_i, w_i), (H_i, W_i), budget) in enumerate(levels):
            if i == 0:
                imgs = left
            else:
                imgs = jax.vmap(
                    lambda im: im_ops.pad_to(
                        jax.image.resize(
                            im[:vh, :vw], (h_i, w_i), method="linear"
                        ),
                        (H_i, W_i),
                    )
                )(left)
            stacked = imgs.reshape(B * H_i, W_i)
            score = _fast_nms(stacked, fe.fast_threshold).reshape(B, H_i, W_i)
            score = fast_ops.mask_border(score, (h_i, w_i), border)
            # lossless 2x2-pooled top_k (ops/fast.nms_topk) — same helper as
            # the single-frame paths, so batch == single stays bit-exact
            top_scores, yx_i = fast_ops.nms_topk(score, budget)

            blurred = im_ops.box_blur(
                imgs.reshape(B * H_i, W_i), fe.blur_box
            ).reshape(B, H_i, W_i)
            packed_i, signs_i, _ = jax.vmap(describe)(blurred, yx_i)

            yx_full = yx_i.astype(jnp.float32) * s
            yx_parts.append(jnp.round(yx_full).astype(jnp.int32))
            yxf_parts.append(yx_full)
            score_parts.append(top_scores)
            scale_parts.append(jnp.full((B, budget), s, jnp.float32))
            packed_parts.append(packed_i)
            signs_parts.append(signs_i)

        yx_int = jnp.concatenate(yx_parts, axis=1)    # (B, N, 2) full-res int
        yx_f = jnp.concatenate(yxf_parts, axis=1)
        score = jnp.concatenate(score_parts, axis=1)
        scale = jnp.concatenate(scale_parts, axis=1)
        packed = jnp.concatenate(packed_parts, axis=1)
        signs = jnp.concatenate(signs_parts, axis=1)

        valid = score > 0.0
        valid = valid & (yx_int[..., 0] < vh) & (yx_int[..., 1] < vw)
        spawn_mask = jax.vmap(
            lambda y, sc: anms_ops.anms_mask(
                y, sc, num=fe.n_features, robust_coeff=fe.anms_robust_coeff
            )
        )(yx_int, score)

        N = yx_int.shape[1]
        if not with_depth:
            zero = jnp.zeros((B, N), jnp.float32)
            return FrameFeatures(
                yx=yx_f, score=score, scale=scale, valid=valid,
                spawn_mask=spawn_mask, signs=signs, packed=packed,
                disparity=zero, depth=zero,
                depth_valid=jnp.zeros((B, N), bool),
                reliable=jnp.zeros((B, N), bool),
                pts_cam=jnp.zeros((B, N, 3), jnp.float32),
            )

        # one stereo sweep over ALL frames' keypoints on the stacked full-res
        # pair; frame b's rows are offset by b * H0 in the stacked canvas
        H0, W0 = left.shape[1], left.shape[2]
        row_off = (jnp.arange(B, dtype=jnp.int32) * H0)[:, None]
        yx_st = jnp.stack(
            [yx_int[..., 0] + row_off, yx_int[..., 1]], axis=-1
        ).reshape(B * N, 2)
        st = stereo_ops.match_disparity(
            left.reshape(B * H0, W0),
            right.reshape(B * H0, W0),
            yx_st,
            valid.reshape(B * N),
            fx=cam.fx,
            baseline=cam.baseline,
            max_disparity=fe.max_disparity,
            patch=fe.stereo_patch,
            min_zncc=fe.min_zncc,
            min_depth=fe.min_depth,
            max_depth=fe.max_depth,
            reliable_depth=fe.reliable_depth,
        )
        st = jax.tree.map(lambda a: a.reshape(B, N), st)
        pts_cam = jax.vmap(
            lambda y, d: stereo_ops.backproject(
                y, d, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy
            )
        )(yx_f, st.depth)
        return FrameFeatures(
            yx=yx_f,
            score=score,
            scale=scale,
            valid=valid,
            spawn_mask=spawn_mask,
            signs=signs,
            packed=packed,
            disparity=st.disparity,
            depth=st.depth,
            depth_valid=st.valid,
            reliable=st.reliable,
            pts_cam=pts_cam,
        )

    return batch_extract


@functools.partial(jax.jit, static_argnames=("hw",))
def prepare_image(img: jnp.ndarray, hw) -> jnp.ndarray:
    """Pad a raw (h, w) image to the static padded shape, f32."""
    return im_ops.pad_to(img.astype(jnp.float32), hw)
