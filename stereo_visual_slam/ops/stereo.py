"""Per-keypoint stereo depth via epipolar ZNCC search.

The reference runs dense SGBM over the full image (visual_odometry.cpp:159-174)
but only ever *samples* the disparity at keypoint locations
(Frame::find_3d, types_def.cpp:9-18). Redesign: compute disparity
only at the N keypoints — for each left keypoint, match a p x p patch against
all right-image candidates along the same row over a 0..D disparity range,
with sub-pixel parabola refinement. This is the "stereo left/right matching"
formulation of the north star, and is ~3 orders of magnitude less work than
dense SGBM at identical downstream behavior.

The ZNCC sweep is batched dynamic-slice strips + one window einsum, run at
"highest" matmul precision: on the GPU an f32 einsum would otherwise run in
TF32, whose ~1e-3 error moves the sub-pixel parabola by hundredths of a
pixel.

Depth gates match the reference: valid 10 m < z < 400 m, reliable z < 40 m
(visual_odometry.cpp:194,201).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class StereoResult(NamedTuple):
    disparity: jnp.ndarray   # (N,) f32, sub-pixel
    depth: jnp.ndarray       # (N,) f32 metres (z in camera frame)
    valid: jnp.ndarray       # (N,) bool — passed score + depth gates
    reliable: jnp.ndarray    # (N,) bool — z < reliable_depth
    score: jnp.ndarray       # (N,) best ZNCC


def zncc_sweep_xla(
    left: jnp.ndarray,
    right: jnp.ndarray,
    yx: jnp.ndarray,
    *,
    patch: int,
    max_disparity: int,
) -> jnp.ndarray:
    """(N, D) ZNCC scores of each keypoint's p x p left patch against the
    right patches at disparities 0..D-1."""
    D = max_disparity
    p = patch
    r = p // 2
    H, W = left.shape

    # Pad right on the left by D so strip starts never go negative, and both
    # by r for the patch window.
    left_p = jnp.pad(left, r)
    right_p = jnp.pad(right, ((r, r), (D + r, r)))

    y = jnp.clip(yx[:, 0], 0, H - 1)
    x = jnp.clip(yx[:, 1], 0, W - 1)

    lp = jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(left_p, (yy, xx), (p, p))
    )(y, x)                                          # (N, p, p)
    strip = jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(
            right_p, (yy, xx + 1), (p, p + D - 1)
        )
    )(y, x)                                          # (N, p, p + D - 1)

    # windows[d] = strip[:, :, (D-1-d) : (D-1-d)+p]
    win = jnp.stack(
        [
            jax.lax.slice_in_dim(strip, (D - 1 - d), (D - 1 - d) + p, axis=2)
            for d in range(D)
        ],
        axis=1,
    )                                                # (N, D, p, p)

    eps = 1e-6
    lp_m = lp - jnp.mean(lp, axis=(1, 2), keepdims=True)
    lp_n = lp_m / (jnp.sqrt(jnp.sum(lp_m * lp_m, axis=(1, 2), keepdims=True)) + eps)
    win_m = win - jnp.mean(win, axis=(2, 3), keepdims=True)
    win_n = win_m / (
        jnp.sqrt(jnp.sum(win_m * win_m, axis=(2, 3), keepdims=True)) + eps
    )
    return jnp.einsum(
        "npq,ndpq->nd", lp_n, win_n, precision=jax.lax.Precision.HIGHEST
    )                                                # (N, D)


@functools.partial(
    jax.jit,
    static_argnames=("max_disparity", "patch", "min_zncc"),
)
def match_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    yx: jnp.ndarray,
    valid_kp: jnp.ndarray,
    *,
    fx: float,
    baseline: float,
    max_disparity: int = 96,
    patch: int = 11,
    min_zncc: float = 0.6,
    min_depth: float = 10.0,
    max_depth: float = 400.0,
    reliable_depth: float = 40.0,
) -> StereoResult:
    """Sub-pixel disparity for N left keypoints. yx int32 (N, 2)."""
    D = max_disparity
    H, W = left.shape
    eps = 1e-6

    zncc = zncc_sweep_xla(left, right, yx, patch=patch, max_disparity=D)

    x = jnp.clip(yx[:, 1], 0, W - 1)
    # disallow disparities that would read left of the (padded) image border
    d_range = jnp.arange(D)[None, :]
    in_image = (x[:, None] - d_range) >= 0
    zncc = jnp.where(in_image, zncc, -2.0)

    best = jnp.argmax(zncc, axis=1)                  # (N,)
    best_s = jnp.take_along_axis(zncc, best[:, None], axis=1)[:, 0]

    # sub-pixel parabola on (best-1, best, best+1)
    bm = jnp.clip(best - 1, 0, D - 1)
    bp = jnp.clip(best + 1, 0, D - 1)
    sm = jnp.take_along_axis(zncc, bm[:, None], axis=1)[:, 0]
    sp = jnp.take_along_axis(zncc, bp[:, None], axis=1)[:, 0]
    denom = sm - 2.0 * best_s + sp
    delta = jnp.where(jnp.abs(denom) > eps, 0.5 * (sm - sp) / denom, 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    disp = best.astype(jnp.float32) + delta

    depth = fx * baseline / jnp.maximum(disp, eps)
    valid = (
        valid_kp
        & (best_s > min_zncc)
        & (best > 0)
        & (best < D - 1)
        & (depth > min_depth)
        & (depth < max_depth)
    )
    reliable = valid & (depth < reliable_depth)
    return StereoResult(disp, depth, valid, reliable, best_s)


def backproject(
    yx: jnp.ndarray,
    depth: jnp.ndarray,
    *,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
) -> jnp.ndarray:
    """Pinhole back-projection to camera-frame 3D (Frame::find_3d,
    types_def.cpp:9-18). yx is (N, 2) (y, x) pixel coords."""
    z = depth
    xcam = (yx[:, 1].astype(jnp.float32) - cx) * z / fx
    ycam = (yx[:, 0].astype(jnp.float32) - cy) * z / fy
    return jnp.stack([xcam, ycam, z], axis=-1)
