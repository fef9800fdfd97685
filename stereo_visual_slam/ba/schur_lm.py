"""Levenberg-Marquardt bundle adjustment with explicit Schur complement.

Replaces the reference's g2o stack — BlockSolver_6_3 + LinearSolverCSparse +
OptimizationAlgorithmLevenberg with marginalized landmark vertices
(optimize_map, optimization.cpp:103-288). The `setMarginalized(true)` at
optimization.cpp:188 is exactly the Schur trick implemented explicitly here.

Dense data layout — the key design decision of this module: a landmark is
observed AT MOST ONCE per keyframe, so the BA "graph" over a K-keyframe
window is a dense (L, K) grid with a validity mask, not a sparse edge list.
Every step of the solver is then a fixed-shape einsum:

    r, Jp, Jl            (L, K, 2[, ...])     linearized edges
    U   = sum_l Jp'WJp   (K, 6, 6)            pose diagonal blocks
    V   = sum_k Jl'WJl   (L, 3, 3)            landmark blocks
    Wb  = Jp'WJl         (L, K, 6, 3)         pose-landmark coupling
    S   = U - Wb V^-1 Wb'  -> dense (6K, 6K)  reduced camera system
    dP  = V^-1 (b_l - Wb' dxi)                landmark back-substitution

At K=10 the reduced solve is a 60x60 Cholesky — negligible; all FLOPs live in
the (L, K) einsums. Distribution (parallel/dist_ba.py)
shards the L axis: each device reduces its landmarks' contributions to
(S, b) and a `psum` of ~15 KB per LM iteration produces the global system —
the communication pattern of the north-star "distributed BA with map-block
partitioning" (BASELINE.json).

Deviations from the reference, both documented improvements:
  * optional gauge anchoring of one pose (reference adds no fixed vertex and
    relies on LM damping, optimization.cpp:127-140),
  * landmark inlier verdict = max chi2 over its observations vs threshold
    (the reference overwrites per-edge in hash order, optimization.cpp:254-266).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from stereo_visual_slam.ba import residuals as res
from stereo_visual_slam.geom import se3


class BAProblem(NamedTuple):
    """Dense-window BA problem. All arrays fixed-shape; masks are float32."""

    T_c_w: jnp.ndarray      # (K, 4, 4) keyframe poses, world -> camera
    points: jnp.ndarray     # (L, 3) landmark positions (world)
    uv: jnp.ndarray         # (L, K, 2) pixel observations
    obs_mask: jnp.ndarray   # (L, K) 1.0 where observed
    point_mask: jnp.ndarray  # (L,) 1.0 for landmarks participating
    pose_mask: jnp.ndarray  # (K,) 1.0 for valid keyframes
    fixed_pose: jnp.ndarray  # (K,) 1.0 for gauge-anchored poses (can be all 0)


class BAResult(NamedTuple):
    T_c_w: jnp.ndarray
    points: jnp.ndarray
    chi2_edges: jnp.ndarray      # (L, K) final squared pixel errors
    landmark_inlier: jnp.ndarray  # (L,) bool after adaptive thresholding
    chi2_threshold: jnp.ndarray  # () final adaptive threshold
    cost: jnp.ndarray            # () final robustified cost


def _maybe_psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


# Closed-form batched small inverses live in geom/linalg.py; re-exported
# here because the Schur math below is their canonical consumer.
from stereo_visual_slam.geom.linalg import inv3x3, solve_block_spd  # noqa: E402


def _edge_weights(r, problem, huber_delta, depth_ok):
    w = (
        problem.obs_mask
        * problem.point_mask[:, None]
        * problem.pose_mask[None, :]
        * depth_ok
        * res.huber_weight(r, huber_delta)
    )
    return w


def _robust_cost(r, problem, huber_delta, depth_ok, axis_name):
    """Total Huber cost (what LM accept/reject compares)."""
    n = jnp.linalg.norm(r, axis=-1)
    delta = huber_delta
    rho = jnp.where(n <= delta, n * n, 2.0 * delta * n - delta * delta)
    m = (
        problem.obs_mask
        * problem.point_mask[:, None]
        * problem.pose_mask[None, :]
        * depth_ok
    )
    return _maybe_psum(jnp.sum(rho * m), axis_name)


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters", "update_points", "axis_name", "matmul_precision"
    ),
)
def lm_optimize(
    problem: BAProblem,
    K: jnp.ndarray,
    *,
    iters: int,
    update_points: bool = True,
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
) -> BAResult:
    """Run up to `iters` LM iterations (early exit when an accepted step
    improves the cost by < rel_tol or damping saturates); classify outliers
    adaptively afterwards.

    `matmul_precision` controls only the STEP-DIRECTION math (the normal
    equations / Schur / solve inside solve_normal_eqs); residuals, Jacobians
    and pose updates are elementwise f32 (residuals.py uses no matmul
    contractions) so they are exact regardless. "default" lets the GPU run
    the f32 step matmuls in TF32 (~1e-3 relative error), and LM acceptance
    — evaluated on exact residuals — guards against any bad step:
    inexact-Newton semantics.

    With `axis_name` set, must be called inside shard_map with the L axis
    sharded; all cross-landmark reductions become psums.
    """
    dtype = problem.points.dtype
    nK = problem.T_c_w.shape[0]
    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)

    free = (problem.pose_mask * (1.0 - problem.fixed_pose))[:, None]  # (K,1)

    def linearize(T, P):
        # broadcast: T (1,K,4,4), P (L,1,3), uv (L,K,2)
        r, Jp, Jl, depth_ok = res.residual_and_jacobians(
            T[None, :, :, :], P[:, None, :], problem.uv, K
        )
        return r, Jp, Jl, depth_ok

    def solve_normal_eqs(r, Jp, Jl, depth_ok, lam):
        with jax.default_matmul_precision(matmul_precision):
            return _solve_normal_eqs(r, Jp, Jl, depth_ok, lam)

    def _solve_normal_eqs(r, Jp, Jl, depth_ok, lam):
        w = _edge_weights(r, problem, huber_delta, depth_ok)  # (L, K)
        # Zero jacobian rows of fixed / invalid poses so their updates are 0.
        Jp = Jp * free[None, :, None, :1].swapaxes(-1, -2)  # (L,K,2,6)*(1,K,1,1)
        Jp = Jp * free[None, :, None, :]

        U = jnp.einsum("lkri,lkrj,lk->kij", Jp, Jp, w)        # (K,6,6)
        V = jnp.einsum("lkri,lkrj,lk->lij", Jl, Jl, w)        # (L,3,3)
        Wb = jnp.einsum("lkri,lkrj,lk->lkij", Jp, Jl, w)      # (L,K,6,3)
        b_p = -jnp.einsum("lkri,lkr,lk->ki", Jp, r, w)        # (K,6)
        b_l = -jnp.einsum("lkri,lkr,lk->li", Jl, r, w)        # (L,3)

        U = _maybe_psum(U, axis_name)
        b_p = _maybe_psum(b_p, axis_name)

        # Marquardt damping on block diagonals.
        U_d = U + lam * (
            eye6 * jnp.maximum(
                jnp.einsum("kii->k", U)[:, None, None] / 6.0, 1.0
            )
        )
        V_d = V + lam * (
            eye3 * jnp.maximum(
                jnp.einsum("lii->l", V)[:, None, None] / 3.0, 1.0
            )
        ) + eye3 * 1e-6
        V_inv = inv3x3(V_d)                                    # (L,3,3)

        if update_points:
            Y = jnp.einsum("lkij,ljm->lkim", Wb, V_inv)        # (L,K,6,3)
            S_cross = jnp.einsum("lkij,lmnj->kimn", Y, Wb)     # (K,6,K,6)
            b_cross = jnp.einsum("lkij,lj->ki", Y, b_l)        # (K,6)
            S_cross = _maybe_psum(S_cross, axis_name)
            b_cross = _maybe_psum(b_cross, axis_name)
        else:
            Y = jnp.zeros_like(Wb)
            S_cross = jnp.zeros((nK, 6, nK, 6), dtype)
            b_cross = jnp.zeros((nK, 6), dtype)

        S = jnp.zeros((nK, 6, nK, 6), dtype)
        S = S.at[jnp.arange(nK), :, jnp.arange(nK), :].set(U_d)
        S = S - S_cross
        b_s = b_p - b_cross

        # Identity rows for fixed/invalid poses keep the matrix SPD.
        free_k = free[:, 0]                                    # (K,)
        mask2 = free_k[:, None, None, None] * free_k[None, None, :, None]
        S = S * mask2
        S = S.at[jnp.arange(nK), :, jnp.arange(nK), :].add(
            eye6 * (1.0 - free_k)[:, None, None]
        )
        b_s = b_s * free_k[:, None]

        S = S.at[jnp.arange(nK), :, jnp.arange(nK), :].add(eye6 * 1e-8)
        # the 60x60 reduced camera system: XLA's LU solve (a cuSOLVER call
        # on the GPU); geom/linalg.solve_block_spd is the unrolled
        # elementwise alternative
        dxi = jnp.linalg.solve(
            S.reshape(6 * nK, 6 * nK), b_s.reshape(6 * nK)
        ).reshape(nK, 6) * free_k[:, None]

        if update_points:
            rhs = b_l - jnp.einsum("lkij,ki->lj", Wb, dxi)
            dP = jnp.einsum("lij,lj->li", V_inv, rhs)
            dP = dP * problem.point_mask[:, None]
        else:
            dP = jnp.zeros_like(b_l)
        return dxi, dP

    def residual_cheap(T, P):
        return res.residual_only(
            T[None, :, :, :], P[:, None, :], problem.uv, K
        )

    def lm_cond(carry):
        i, _, _, _, _, done = carry
        return (i < iters) & ~done

    def lm_body(carry):
        # Linearize unconditionally at the current accepted point: a
        # rejected step re-linearizes unchanged (T, P) — identical values,
        # and cheaper than carrying the ~3.4 MB (r, Jp, Jl) pytree through a
        # lax.cond select every iteration (measured, two-length fori method).
        i, T, P, lam, cost, done = carry
        lin = linearize(T, P)
        dxi, dP = solve_normal_eqs(*lin, lam)
        T_new = se3.normalize_rotation(se3.compose(se3.exp(dxi), T))
        P_new = P + dP
        r2, d2 = residual_cheap(T_new, P_new)
        cost_new = _robust_cost(r2, problem, huber_delta, d2, axis_name)
        accept = cost_new < cost
        # converged: an ACCEPTED step improved the cost by < rel_tol, or
        # rejections drove the damping to saturation (steps are then ~0)
        done = (accept & (cost - cost_new <= rel_tol * cost)) | (lam >= 1e7)
        sel = lambda a, b: jnp.where(accept, a, b)
        T = jax.tree.map(sel, T_new, T)
        P = jax.tree.map(sel, P_new, P)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * lambda_down, 1e-10),
            jnp.minimum(lam * lambda_up, 1e8),
        )
        return i + 1, T, P, lam, cost, done

    T0 = problem.T_c_w
    P0 = problem.points
    # initial cost needs residuals only — the first lm_body iteration
    # linearizes at (T0, P0) anyway, so a full Jacobian eval here would be
    # pure waste (one (L,K,2,9) materialization per lm_optimize call)
    r0, d0 = residual_cheap(T0, P0)
    cost0 = _robust_cost(r0, problem, huber_delta, d0, axis_name)
    lam0 = jnp.asarray(lambda_init, dtype)
    _, T, P, lam, cost, _ = jax.lax.while_loop(
        lm_cond,
        lm_body,
        (jnp.asarray(0, jnp.int32), T0, P0, lam0, cost0,
         jnp.asarray(False)),
    )

    # ---- adaptive chi2 outlier classification (optimization.cpp:224-252) ----
    r, depth_ok = residual_cheap(T, P)
    chi2 = jnp.sum(r * r, axis=-1)                            # (L, K)
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

    # Landmark verdict: worst observation must pass the final threshold.
    worst = jnp.max(jnp.where(m > 0, chi2, 0.0), axis=1)      # (L,)
    has_obs = jnp.sum(m, axis=1) > 0
    landmark_inlier = (worst <= th) & has_obs

    return BAResult(
        T_c_w=T,
        points=P,
        chi2_edges=chi2,
        landmark_inlier=landmark_inlier,
        chi2_threshold=th,
        cost=cost,
    )
