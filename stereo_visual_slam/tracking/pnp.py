"""Vectorized PnP-RANSAC + robust Gauss-Newton pose refinement.

Replaces cv::solvePnPRansac(100 iters, 4.0 px, 0.99) + Rodrigues
(VO::motion_estimation, visual_odometry.cpp:253-314). Batched design:

  * instead of a sequential hypothesize-and-verify loop, ALL hypotheses run
    at once: H minimal 4-point sets are sampled with Gumbel top-k over the
    validity mask, each fit by a small damped Gauss-Newton from a motion
    prior (constant-velocity pose), all vmapped — H x (6x6) solves,
  * scoring is one (H, N) reprojection-error matrix; best hypothesis by
    masked inlier count at 4 px,
  * final pose = Huber-weighted GN over the best hypothesis' inliers,
    re-counting inliers afterwards (the reference erases outlier features;
    we return the inlier mask and the caller masks features).

The residual/Jacobian math is shared with the BA backend (ba/residuals.py):
e = uv - pi(K (T p)) with the analytic 2x6 left-perturbation Jacobian of
optimization.cpp:52-73.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_visual_slam.ba import residuals as res
from stereo_visual_slam.geom import se3
from stereo_visual_slam.geom.linalg import solve6


class PnPResult(NamedTuple):
    T_c_w: jnp.ndarray        # (4, 4) estimated pose
    inlier_mask: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray    # () int32
    best_score: jnp.ndarray   # () int32 — inliers of the winning hypothesis


def _gn_step(T, pts_w, uv, w, K, damping):
    """One damped Gauss-Newton step on pose only. w: (N,) weights."""
    r, Jp, depth_ok = res.reprojection_residual_jac(T, pts_w, uv, K)
    w = w * depth_ok
    JtJ = jnp.einsum("nri,nrj,n->ij", Jp, Jp, w)
    Jtr = jnp.einsum("nri,nr,n->i", Jp, r, w)
    A = JtJ + damping * jnp.eye(6, dtype=T.dtype)
    # closed-form 6x6 solve (geom/linalg.py): fuses into the GN loop body
    # instead of a separate solver call per iteration
    delta = solve6(A, -Jtr)
    return se3.compose(se3.exp(delta), T)


def _huber_weights(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS Huber weight on the residual 2-norm: w = min(1, delta/||r||)."""
    n = jnp.linalg.norm(r, axis=-1)
    return jnp.minimum(1.0, delta / jnp.maximum(n, 1e-9))


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_hypotheses",
        "sample_size",
        "gn_iters_hypothesis",
        "gn_iters_refine",
    ),
)
def solve_pnp_ransac(
    pts_w: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    T_init: jnp.ndarray,
    rng_key: jnp.ndarray,
    *,
    n_hypotheses: int = 128,
    sample_size: int = 4,
    inlier_px: float = 4.0,
    gn_iters_hypothesis: int = 10,
    gn_iters_refine: int = 10,
    huber_px: float = 4.0,
    prior_spread=0.0,
) -> PnPResult:
    """Estimate T_c_w from world points (N,3) and pixels (N,2) with outliers.

    T_init: motion prior (e.g. constant-velocity extrapolation); hypotheses
    start from it, so convergence per minimal set takes a handful of GN steps.

    prior_spread (metres, traced scalar ok): hypothesis-start diversity. The
    first half of the hypotheses start exactly at T_init; the other half at
    T_init perturbed by random twists with translation std ramping up to
    prior_spread (rotation std 5 % of that, radians). A wrong prior (erratic
    motion, recovery after rejections) then cannot collapse ALL hypotheses
    into one bad GN basin — the diversity role cv::solvePnPRansac's
    prior-free minimal solves play in the reference (vo.cpp:277).
    """
    # Fence the inputs: when fused with an upstream matcher, XLA would
    # otherwise rematerialize the producer chains (e.g. the full N x M
    # descriptor-distance matrix) inside the RANSAC/GN loops — measured as a
    # 10x slowdown of the fused per-frame step.
    pts_w, uv, valid, T_init = jax.lax.optimization_barrier(
        (pts_w, uv, valid, T_init)
    )
    N = pts_w.shape[0]
    dtype = pts_w.dtype

    # --- sample H minimal sets over valid entries (Gumbel top-k) ---
    k_sample, k_perturb = jax.random.split(rng_key)
    g = jax.random.gumbel(k_sample, (n_hypotheses, N), dtype=dtype)
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, sample_idx = jax.lax.top_k(g, sample_size)          # (H, S)

    # --- hypothesis start diversity: half exact prior, half perturbed with
    #     a per-hypothesis scale ramp 0..prior_spread ---
    spread = jnp.asarray(prior_spread, dtype)
    ramp = jnp.linspace(0.0, 1.0, n_hypotheses, dtype=dtype)
    scale = jnp.where(
        jnp.arange(n_hypotheses) < n_hypotheses // 2, 0.0, ramp
    ) * spread                                              # (H,)
    twists = jax.random.normal(k_perturb, (n_hypotheses, 6), dtype=dtype)
    twists = twists * scale[:, None] * jnp.asarray(
        [1.0, 1.0, 1.0, 0.05, 0.05, 0.05], dtype
    )
    T_starts = jax.vmap(lambda d: se3.compose(se3.exp(d), T_init))(twists)

    def fit_one(idx, T_start):
        p = pts_w[idx]                                      # (S, 3)
        u = uv[idx]                                         # (S, 2)
        w = jnp.ones((sample_size,), dtype)

        def body(_, T):
            return _gn_step(T, p, u, w, K, jnp.asarray(1e-4, dtype))

        return jax.lax.fori_loop(0, gn_iters_hypothesis, body, T_start)

    T_hyp = jax.vmap(fit_one)(sample_idx, T_starts)         # (H, 4, 4)

    # --- score all hypotheses against all points ---
    def score_one(T):
        r, _, depth_ok = res.reprojection_residual_jac(T, pts_w, uv, K)
        err = jnp.linalg.norm(r, axis=-1)
        inl = valid & depth_ok.astype(bool) & (err < inlier_px)
        return jnp.sum(inl.astype(jnp.int32)), inl

    scores, inlier_sets = jax.vmap(score_one)(T_hyp)        # (H,), (H, N)
    best = jnp.argmax(scores)
    best_score = scores[best]
    T_best = T_hyp[best]
    inl0 = inlier_sets[best]

    # --- robust refinement on the winning consensus set ---
    def refine_body(_, T):
        r, _, depth_ok = res.reprojection_residual_jac(T, pts_w, uv, K)
        w = (
            _huber_weights(r, huber_px)
            * inl0.astype(dtype)
            * depth_ok
        )
        return _gn_step(T, pts_w, uv, w, K, jnp.asarray(1e-6, dtype))

    T_ref = jax.lax.fori_loop(0, gn_iters_refine, refine_body, T_best)
    T_ref = se3.normalize_rotation(T_ref)

    # --- final inlier classification at the refined pose ---
    r, _, depth_ok = res.reprojection_residual_jac(T_ref, pts_w, uv, K)
    err = jnp.linalg.norm(r, axis=-1)
    inlier_mask = valid & depth_ok.astype(bool) & (err < inlier_px)
    # fall back to the prior if RANSAC found (almost) nothing
    ok = best_score >= 4
    T_out = jnp.where(ok, T_ref, T_init)
    return PnPResult(
        T_c_w=T_out,
        inlier_mask=inlier_mask & ok,
        n_inliers=jnp.sum((inlier_mask & ok).astype(jnp.int32)),
        best_score=best_score,
    )
