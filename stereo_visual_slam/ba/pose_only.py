"""Pose-only bundle adjustment (landmarks fixed).

Replaces `optimize_pose_only` (optimization.cpp:290-436): unary
PoseOnlyEdgeProjection edges and a dense solver, same adaptive chi2 loop,
updates only poses. Because edges are unary, the normal equations decouple
into independent 6x6 systems per keyframe — we batch all K solves as one
(K, 6, 6) `jnp.linalg.solve`, i.e. the whole backend step is a couple of
einsums regardless of K.

Filter semantics match the reference: landmarks participate if `is_inlier`
(reliable_depth NOT required, optimization.cpp:332-337).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from stereo_visual_slam.ba import residuals as res
from stereo_visual_slam.ba.schur_lm import BAProblem, _maybe_psum
from stereo_visual_slam.geom import se3
from stereo_visual_slam.geom.linalg import solve6


class PoseOnlyResult(NamedTuple):
    T_c_w: jnp.ndarray
    chi2_edges: jnp.ndarray
    landmark_inlier: jnp.ndarray
    chi2_threshold: jnp.ndarray
    cost: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("iters", "axis_name", "matmul_precision")
)
def optimize_pose_only(
    problem: BAProblem,
    K: jnp.ndarray,
    *,
    iters: int,
    huber_delta: float = 5.991,
    chi2_threshold: float = 5.991,
    adaptive_rounds: int = 5,
    target_inlier_ratio: float = 0.5,
    lambda_init: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.5,
    rel_tol: float = 1e-6,
    axis_name: Optional[str] = None,
    matmul_precision: str = "default",
) -> PoseOnlyResult:
    dtype = problem.points.dtype
    nK = problem.T_c_w.shape[0]
    eye6 = jnp.eye(6, dtype=dtype)
    free = problem.pose_mask * (1.0 - problem.fixed_pose)  # (K,)

    def linearize(T):
        r, Jp, depth_ok = res.reprojection_residual_jac(
            T[None, :, :, :], problem.points[:, None, :], problem.uv, K
        )
        return r, Jp, depth_ok

    def weights(r, depth_ok):
        return (
            problem.obs_mask
            * problem.point_mask[:, None]
            * problem.pose_mask[None, :]
            * depth_ok
            * res.huber_weight(r, huber_delta)
        )

    def robust_cost(r, depth_ok):
        n = jnp.linalg.norm(r, axis=-1)
        d = huber_delta
        rho = jnp.where(n <= d, n * n, 2.0 * d * n - d * d)
        m = (
            problem.obs_mask
            * problem.point_mask[:, None]
            * problem.pose_mask[None, :]
            * depth_ok
        )
        return _maybe_psum(jnp.sum(rho * m), axis_name)

    def residual_cheap(T):
        return res.residual_only(
            T[None, :, :, :], problem.points[:, None, :], problem.uv, K
        )

    def solve(lin, lam):
        # step-direction math at fast matmul precision; acceptance below is
        # evaluated on exact residuals (see schur_lm.lm_optimize docstring)
        with jax.default_matmul_precision(matmul_precision):
            r, Jp, depth_ok = lin
            w = weights(r, depth_ok)
            H = jnp.einsum("lkri,lkrj,lk->kij", Jp, Jp, w)    # (K,6,6)
            b = -jnp.einsum("lkri,lkr,lk->ki", Jp, r, w)      # (K,6)
            H = _maybe_psum(H, axis_name)
            b = _maybe_psum(b, axis_name)
            H = H + lam * eye6 * jnp.maximum(
                jnp.einsum("kii->k", H)[:, None, None] / 6.0, 1.0
            ) + eye6 * 1e-8
            dxi = solve6(H, b)                                # (K,6)
            return dxi * free[:, None]

    def cond_fn(carry):
        i, _, _, _, done = carry
        return (i < iters) & ~done

    def body(carry):
        # linearize unconditionally (see schur_lm.lm_body): identical values
        # on rejected steps, cheaper than a lax.cond-selected cached pytree
        i, T, lam, cost, done = carry
        lin = linearize(T)
        dxi = solve(lin, lam)
        T_new = se3.normalize_rotation(se3.compose(se3.exp(dxi), T))
        r2, d2 = residual_cheap(T_new)
        cost_new = robust_cost(r2, d2)
        accept = cost_new < cost
        done = (accept & (cost - cost_new <= rel_tol * cost)) | (lam >= 1e7)
        T = jnp.where(accept, T_new, T)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * lambda_down, 1e-10),
            jnp.minimum(lam * lambda_up, 1e8),
        )
        return i + 1, T, lam, cost, done

    # residuals only — the first loop iteration re-linearizes at the same
    # point (see schur_lm: a full Jacobian eval here is pure waste)
    r0, d0 = residual_cheap(problem.T_c_w)
    cost0 = robust_cost(r0, d0)
    _, T, lam, cost, _ = jax.lax.while_loop(
        cond_fn, body,
        (jnp.asarray(0, jnp.int32), problem.T_c_w,
         jnp.asarray(lambda_init, dtype), cost0, jnp.asarray(False)),
    )

    r, depth_ok = residual_cheap(T)
    chi2 = jnp.sum(r * r, axis=-1)
    m = (
        problem.obs_mask
        * problem.point_mask[:, None]
        * problem.pose_mask[None, :]
        * depth_ok
    )
    n_edges = _maybe_psum(jnp.sum(m), axis_name)

    def adapt_body(_, th):
        n_in = _maybe_psum(jnp.sum((chi2 <= th) * m), axis_name)
        ratio = n_in / jnp.maximum(n_edges, 1.0)
        return jnp.where(ratio > target_inlier_ratio, th, th * 2.0)

    th = jax.lax.fori_loop(
        0, adaptive_rounds, adapt_body, jnp.asarray(chi2_threshold, dtype)
    )
    worst = jnp.max(jnp.where(m > 0, chi2, 0.0), axis=1)
    has_obs = jnp.sum(m, axis=1) > 0
    landmark_inlier = (worst <= th) & has_obs
    return PoseOnlyResult(T, chi2, landmark_inlier, th, cost)
