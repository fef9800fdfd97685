"""The full per-keyframe BA schedule as ONE device program.

The reference runs four g2o optimizations per inserted keyframe
(run_vslam.cpp:58-71):

    optimize_map(..., update=false, 5)   x2   # outlier-rejection passes
    optimize_map(..., update_poses, 10)       # poses written, landmarks NOT
    optimize_pose_only(..., update, 10)

Running these as four host-driven dispatches costs dozens of host<->device
round trips per keyframe. Here the whole schedule is a single jitted
program: the host uploads the assembled window once, the inlier set flows
from pass to pass on device (point_mask updates between phases, mirroring
the is_inlier writeback semantics of optimization.cpp:254-266), and one
fetch returns optimized poses + final verdicts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from stereo_visual_slam.ba import pose_only as pose_only_mod
from stereo_visual_slam.ba import schur_lm
from stereo_visual_slam.utils.config import BAConfig
from stereo_visual_slam.utils.hostconst import build_on_host

LM_AXIS = "lm"


class ScheduleInput(NamedTuple):
    """Window assembled once on the host. Masks are float32 {0, 1}."""

    T_c_w: jnp.ndarray      # (K, 4, 4)
    points: jnp.ndarray     # (L, 3)
    uv: jnp.ndarray         # (L, K, 2)
    obs_mask: jnp.ndarray   # (L, K)
    inlier: jnp.ndarray     # (L,) current landmark is_inlier flags
    reliable: jnp.ndarray   # (L,) landmark reliable_depth_ flags
    present: jnp.ndarray    # (L,) row holds a real landmark
    pose_mask: jnp.ndarray  # (K,)
    fixed_pose: jnp.ndarray  # (K,)


class ScheduleResult(NamedTuple):
    T_c_w: jnp.ndarray        # (K, 4, 4) optimized poses
    inlier: jnp.ndarray       # (L,) final is_inlier verdicts
    cost_full: jnp.ndarray    # () robust cost after the full BA pass
    cost_pose: jnp.ndarray    # () robust cost after pose-only
    threshold: jnp.ndarray    # () final adaptive chi2 threshold


@build_on_host
def make_ba_schedule(cfg: BAConfig, mesh=None, axis_name: Optional[str] = None):
    """Build the jitted schedule closed over the static BA config.

    Distribution (the live-pipeline integration of parallel/dist_ba.py's
    north-star layout): with `mesh`, the WHOLE schedule runs landmark-sharded
    under shard_map — each device owns L/n arena rows, reduces its landmarks'
    Schur contributions locally, and one psum of the reduced (6K x 6K + 6K)
    camera system per LM iteration is the only collective (NCCL over NVLink
    between GPUs). Poses are replicated.
    With `axis_name` (already inside a shard_map), the psums are inserted
    but no wrapping happens.
    """
    if mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        inner = make_ba_schedule(cfg, axis_name=LM_AXIS)
        in_specs = ScheduleInput(
            T_c_w=P(), points=P(LM_AXIS), uv=P(LM_AXIS),
            obs_mask=P(LM_AXIS), inlier=P(LM_AXIS), reliable=P(LM_AXIS),
            present=P(LM_AXIS), pose_mask=P(), fixed_pose=P(),
        )
        out_specs = ScheduleResult(
            T_c_w=P(), inlier=P(LM_AXIS), cost_full=P(), cost_pose=P(),
            threshold=P(),
        )
        return shard_map(
            inner, mesh=mesh, in_specs=(in_specs, P()),
            out_specs=out_specs, check_vma=False,
        )

    common = dict(
        huber_delta=cfg.huber_delta,
        chi2_threshold=cfg.chi2_threshold,
        adaptive_rounds=cfg.adaptive_rounds,
        target_inlier_ratio=cfg.target_inlier_ratio,
        lambda_init=cfg.lm_lambda_init,
        lambda_up=cfg.lm_lambda_up,
        lambda_down=cfg.lm_lambda_down,
        rel_tol=cfg.rel_tol,
        matmul_precision=cfg.matmul_precision,
        axis_name=axis_name,
    )

    @jax.jit
    def run(inp: ScheduleInput, K: jnp.ndarray) -> ScheduleResult:
        inlier = inp.inlier * inp.present

        def problem(point_mask, T):
            return schur_lm.BAProblem(
                T_c_w=T,
                points=inp.points,
                uv=inp.uv,
                obs_mask=inp.obs_mask,
                point_mask=point_mask,
                pose_mask=inp.pose_mask,
                fixed_pose=inp.fixed_pose,
            )

        def apply_verdict(inlier, participated, verdict):
            """Verdicts only touch landmarks that took part in the pass —
            others keep their flag (optimization.cpp:254-266 iterates only
            the edges that were added)."""
            v = verdict.astype(inlier.dtype)
            return jnp.where(participated > 0, inlier * v, inlier)

        T = inp.T_c_w
        # -- classify passes: optimize a scratch copy, keep only the verdict
        for _ in range(cfg.classify_passes):
            pm = inlier * inp.reliable
            res = schur_lm.lm_optimize(
                problem(pm, T), K, iters=cfg.classify_iters, **common
            )
            inlier = apply_verdict(inlier, pm, res.landmark_inlier)

        # -- full BA: poses are kept, landmark positions are NOT
        #    (run_vslam.cpp:64: if_update_landmark = false pins stereo scale)
        pm = inlier * inp.reliable
        res_full = schur_lm.lm_optimize(
            problem(pm, T), K, iters=cfg.full_iters, **common
        )
        T = res_full.T_c_w
        inlier = apply_verdict(inlier, pm, res_full.landmark_inlier)

        # -- pose-only refinement over ALL inlier landmarks (no reliable
        #    filter, optimization.cpp:332-337), landmarks fixed
        res_po = pose_only_mod.optimize_pose_only(
            problem(inlier, T), K, iters=cfg.pose_only_iters, **common
        )
        T = res_po.T_c_w
        inlier = apply_verdict(inlier, inlier, res_po.landmark_inlier)

        return ScheduleResult(
            T_c_w=T,
            inlier=inlier > 0,
            cost_full=res_full.cost,
            cost_pose=res_po.cost,
            threshold=res_po.chi2_threshold,
        )

    return run
