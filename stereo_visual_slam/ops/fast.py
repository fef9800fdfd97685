"""FAST-9/16 corner detection as dense, fixed-shape array ops.

Re-design of the reference's `cv::ORB` detection stage
(visual_odometry.cpp:70-94): instead of producing a dynamic keypoint list, we
compute a dense corner *score map* (elementwise math over 16 shifted views
of the image), 3x3 non-max suppress it, and take a static top-K.
Data-dependent sparsity becomes dense compute + top_k — the idiomatic mapping
of FAST onto a dense-compute machine (SURVEY.md §7 "hard parts").

The score is OpenCV-compatible in spirit: the largest threshold t' for which
the pixel would still pass the 9-contiguous test, approximated as
max over valid arcs of (min over the arc of |I_j - I_p|).

This module is the XLA formulation: the reference for every path, and the
score map off the GPU. On the GPU the frontend computes the same score map
with the Triton-route kernel in ops/pallas/fast_kernel.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, in circular order, as (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shifted_views(img: jnp.ndarray) -> jnp.ndarray:
    """(16, H, W) where view j holds I(p + offset_j), zero-padded at borders."""
    H, W = img.shape
    padded = jnp.pad(img, 3)
    views = [
        jax.lax.dynamic_slice(padded, (3 + dy, 3 + dx), (H, W))
        for dy, dx in CIRCLE_OFFSETS
    ]
    return jnp.stack(views, axis=0)


def fast_score_map(img: jnp.ndarray, threshold: float, arc: int = 9) -> jnp.ndarray:
    """Dense FAST-9/16 score map, zero where not a corner. img: (H, W) f32."""
    circle = _shifted_views(img)          # (16, H, W)
    diff = circle - img[None]             # (16, H, W)

    score = jnp.zeros_like(img)
    for sign in (1.0, -1.0):
        d = diff * sign                   # bright pass then dark pass
        ok = d > threshold                # (16, H, W)
        mag = jnp.where(ok, d, 0.0)
        # run the 16 circular windows of length `arc`: valid_k = AND of arc,
        # strength_k = min over arc. Wrap via concatenation.
        ok2 = jnp.concatenate([ok, ok[: arc - 1]], axis=0)
        mag2 = jnp.concatenate([mag, mag[: arc - 1]], axis=0)
        best = jnp.zeros_like(img)
        for k in range(16):
            valid = jnp.all(ok2[k : k + arc], axis=0)
            strength = jnp.min(mag2[k : k + arc], axis=0)
            best = jnp.maximum(best, jnp.where(valid, strength, 0.0))
        score = jnp.maximum(score, best)
    return score


def nms_3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only local maxima in a 3x3 neighborhood (ties broken toward the
    earlier pixel in raster order, via strict > against shifted neighbors that
    come later and >= against earlier ones)."""
    H, W = score.shape
    padded = jnp.pad(score, 1, constant_values=-jnp.inf)
    keep = jnp.ones_like(score, dtype=bool)
    idx = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                idx += 1
                continue
            neigh = jax.lax.dynamic_slice(padded, (1 + dy, 1 + dx), (H, W))
            later = (dy > 0) or (dy == 0 and dx > 0)
            if later:
                keep &= score >= neigh
            else:
                keep &= score > neigh
            idx += 1
    return jnp.where(keep, score, 0.0)


def nms_topk(
    score: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k of an NMS'd score map via a LOSSLESS 2x2 max-pool.

    After 3x3 NMS with raster-order tie-breaking, any 2x2 block holds at
    most one nonzero score (two surviving corners can never be 8-adjacent),
    so max-pooling 2x2 and running top_k on the 4x-smaller map selects
    exactly the same corners. Ordering among EQUAL scores follows pooled-
    block raster order instead of pixel raster order; all detect paths use
    this helper, so every path agrees bit-for-bit.

    score: (..., H, W), H and W even. Returns (scores (..., k),
    yx (..., k, 2) int32). Zero-score rows are padding (callers mask on
    score > 0); their coordinates are deterministic but meaningless.
    """
    *lead, H, W = score.shape
    if H % 2 or W % 2:  # odd shapes: plain top_k (tests on tiny images)
        flat = score.reshape(*lead, H * W)
        top_scores, top_idx = jax.lax.top_k(flat, k)
        yx = jnp.stack([top_idx // W, top_idx % W], axis=-1)
        return top_scores, yx.astype(jnp.int32)
    H2, W2 = H // 2, W // 2
    # 2x2 max-pool
    window = (1,) * len(lead) + (2, 2)
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, window, window, "VALID"
    )
    top_scores, top_idx = jax.lax.top_k(pooled.reshape(*lead, H2 * W2), k)
    # resolve the winning pixel inside each selected 2x2 block by gathering
    # its sub-scores (tie order a, b, c, d = raster) — k tiny gathers
    # instead of materializing a dense M-sized `off` map
    y2 = top_idx // W2
    x2 = top_idx % W2
    base = (2 * y2) * W + 2 * x2
    sflat = score.reshape(*lead, H * W)
    ga = jnp.take_along_axis(sflat, base, axis=-1)
    gb = jnp.take_along_axis(sflat, base + 1, axis=-1)
    gc = jnp.take_along_axis(sflat, base + W, axis=-1)
    sel = jnp.where(
        ga == top_scores,
        0,
        jnp.where(gb == top_scores, 1, jnp.where(gc == top_scores, 2, 3)),
    )
    y = 2 * y2 + sel // 2
    x = 2 * x2 + (sel & 1)
    return top_scores, jnp.stack([y, x], axis=-1).astype(jnp.int32)


def mask_border(score: jnp.ndarray, valid_hw, border: int) -> jnp.ndarray:
    """Zero the scores of (..., H, W) maps outside the valid (h, w) region
    shrunk by `border` pixels."""
    H, W = score.shape[-2:]
    h, w = valid_hw
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    return jnp.where(inside, score, 0.0)


@functools.partial(jax.jit, static_argnames=("max_kp", "threshold", "border"))
def detect(
    img: jnp.ndarray,
    *,
    max_kp: int,
    threshold: float = 20.0,
    border: int = 20,
    valid_hw=None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FAST detection -> static top-K keypoints.

    Returns (yx (K, 2) int32, score (K,) f32); entries with score 0 are
    padding. `valid_hw` masks off the padded image region (h, w scalars).
    """
    score = nms_3x3(fast_score_map(img, threshold))
    score = mask_border(score, valid_hw or img.shape, border)
    top_scores, yx = nms_topk(score, max_kp)
    return yx, top_scores
