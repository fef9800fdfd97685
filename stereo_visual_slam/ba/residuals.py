"""Reprojection residual + analytic Jacobians — the numeric hot kernel of BA.

Reproduces the g2o edge math of the reference (SURVEY.md §3.5):

  EdgeProjection::computeError   (optimization.cpp:41-50):
      e = u - pi(K * (T * P))            (2-vector, pixel units)
  EdgeProjection::linearizeOplus (optimization.cpp:52-73):
      de/dxi : 2x6 analytic Jacobian for a LEFT perturbation T <- exp(d) T,
      de/dP  : 2x3 = (de/dXc) * R.

Sign convention: we return r = pi(K T P) - u (so GN minimizes ||r||^2 and
steps use -J^T r; equivalent to the reference up to the global sign).

All math here is EXPLICIT elementwise multiply/add — no `@`, no einsum with
matmul contractions — so it is bit-exact f32 under ANY ambient
jax.default_matmul_precision. This is what lets the LM solvers run their
normal-equation/Schur matmuls at fast (TF32) precision while residual
evaluation, cost, and acceptance tests stay exact (inexact-Newton).

All functions broadcast over leading batch dimensions and are float32-safe
(depth clamped away from zero; a `depth_ok` mask flags points behind or too
close to the camera so callers can zero their contributions).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

_MIN_Z = 1e-3


def transform(T_c_w: jnp.ndarray, pts_w: jnp.ndarray) -> jnp.ndarray:
    """Rigid transform (..., 4, 4) x (..., 3) -> (..., 3), elementwise
    (9 multiplies), exact f32 at any matmul precision."""
    R = T_c_w[..., :3, :3]
    t = T_c_w[..., :3, 3]
    # sum_j R[..., i, j] * p[..., j] written as broadcasted mul + reduce
    return jnp.sum(R * pts_w[..., None, :], axis=-1) + t


def project(Xc: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = jnp.maximum(Xc[..., 2], _MIN_Z)
    u = fx * Xc[..., 0] / z + cx
    v = fy * Xc[..., 1] / z + cy
    return jnp.stack([u, v], axis=-1)


def residual_only(
    T_c_w: jnp.ndarray, pts_w: jnp.ndarray, uv: jnp.ndarray, K: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Residual + depth mask WITHOUT Jacobians — the cheap evaluation used
    for LM step acceptance and the adaptive chi2 classification, where the
    full linearization would waste ~2/3 of the edge FLOPs."""
    Xc = transform(T_c_w, pts_w)
    depth_ok = (Xc[..., 2] > _MIN_Z).astype(pts_w.dtype)
    return project(Xc, K) - uv, depth_ok


def residual_and_jacobians(
    T_c_w: jnp.ndarray,
    pts_w: jnp.ndarray,
    uv: jnp.ndarray,
    K: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full edge linearization.

    Args (broadcastable): T_c_w (..., 4, 4), pts_w (..., 3), uv (..., 2).
    Returns:
      r        (..., 2)    residual  pi(K T P) - u
      J_pose   (..., 2, 6) wrt left-perturbation twist [v, w]
      J_point  (..., 2, 3) wrt world point
      depth_ok (..., )     f32 1.0 where Xc.z > _MIN_Z

    The 2x6 pose Jacobian is the closed form of Jproj @ [I | -hat(Xc)]
    (optimization.cpp:52-73), expanded so no matrix product appears:

      [ fx/Z   0    -fx X/Z²  -fx XY/Z²   fx+fx X²/Z²  -fx Y/Z ]
      [ 0    fy/Z   -fy Y/Z²  -fy-fy Y²/Z²  fy XY/Z²    fy X/Z ]
    """
    fx, fy = K[0, 0], K[1, 1]
    R = T_c_w[..., :3, :3]
    Xc = transform(T_c_w, pts_w)
    depth_ok = (Xc[..., 2] > _MIN_Z).astype(pts_w.dtype)

    r = project(Xc, K) - uv

    X, Y = Xc[..., 0], Xc[..., 1]
    Z = jnp.maximum(Xc[..., 2], _MIN_Z)
    iz = 1.0 / Z
    iz2 = iz * iz
    zero = jnp.zeros_like(X)

    a = fx * iz                  # dproj_u/dX
    c = -fx * X * iz2            # dproj_u/dZ
    b = fy * iz                  # dproj_v/dY
    d = -fy * Y * iz2            # dproj_v/dZ

    row0 = jnp.stack(
        [a, zero, c, c * Y, fx + fx * X * X * iz2, -fx * Y * iz], axis=-1
    )
    row1 = jnp.stack(
        [zero, b, d, -fy - fy * Y * Y * iz2, -d * X, fy * X * iz], axis=-1
    )
    J_pose = jnp.stack([row0, row1], axis=-2)           # (..., 2, 6)

    # J_point = Jproj @ R, expanded: row_u = a*R[0,:] + c*R[2,:]
    Jpt_u = a[..., None] * R[..., 0, :] + c[..., None] * R[..., 2, :]
    Jpt_v = b[..., None] * R[..., 1, :] + d[..., None] * R[..., 2, :]
    J_point = jnp.stack([Jpt_u, Jpt_v], axis=-2)        # (..., 2, 3)
    return r, J_pose, J_point, depth_ok


def reprojection_residual_jac(
    T_c_w: jnp.ndarray, pts_w: jnp.ndarray, uv: jnp.ndarray, K: jnp.ndarray
):
    """Pose-only variant (PoseOnlyEdgeProjection, optimization.cpp:75-101)."""
    r, J_pose, _, depth_ok = residual_and_jacobians(T_c_w, pts_w, uv, K)
    return r, J_pose, depth_ok


def huber_weight(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weight for g2o's RobustKernelHuber with delta on chi2's sqrt:
    the reference sets delta = 5.991 on e = ||r||^2... in g2o the kernel is
    quadratic while e <= delta^2, i.e. while ||r|| <= delta. IRLS weight
    w = min(1, delta / ||r||) reproduces the same influence curve."""
    n = jnp.linalg.norm(r, axis=-1)
    return jnp.minimum(1.0, delta / jnp.maximum(n, 1e-9))
