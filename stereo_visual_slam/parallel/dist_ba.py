"""Distributed bundle adjustment over a device mesh.

The north-star design (BASELINE.json): partition the MAP — landmark blocks —
across devices; each device reduces its landmarks' contributions to the
Schur-complement camera system; one `psum` of the reduced (6K x 6K + 6K)
system per LM iteration (NCCL over NVLink between GPUs); the solve is
replicated; landmark
back-substitution is local. Communication per iteration is ~15 KB regardless
of map size, so scaling is limited only by the (embarrassingly parallel)
per-landmark einsums.

This wraps `ba.schur_lm.lm_optimize` (which already takes `axis_name` and
inserts the psums) in a `shard_map` over the landmark axis. The same wrapper
pattern serves `pose_only`.

Also provides `shard_problem` to place a host-assembled BAProblem onto the
mesh with the right shardings (landmark-sharded tables, replicated poses).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereo_visual_slam.ba import pose_only as pose_only_mod
from stereo_visual_slam.ba import schur_lm

LM_AXIS = "lm"

_PROBLEM_SPECS = schur_lm.BAProblem(
    T_c_w=P(),            # replicated poses
    points=P(LM_AXIS),    # landmark-sharded
    uv=P(LM_AXIS),
    obs_mask=P(LM_AXIS),
    point_mask=P(LM_AXIS),
    pose_mask=P(),
    fixed_pose=P(),
)


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(devices, (LM_AXIS,))


def shard_problem(problem: schur_lm.BAProblem, mesh: Mesh) -> schur_lm.BAProblem:
    """Place a BAProblem onto the mesh (L must divide the mesh size)."""
    return jax.tree.map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        problem,
        _PROBLEM_SPECS,
    )


def distributed_lm_optimize(
    problem: schur_lm.BAProblem,
    K: jnp.ndarray,
    mesh: Mesh,
    *,
    iters: int,
    **kwargs,
) -> schur_lm.BAResult:
    """Landmark-sharded LM + Schur BA. Poses replicated; landmarks local."""
    out_specs = schur_lm.BAResult(
        T_c_w=P(),
        points=P(LM_AXIS),
        chi2_edges=P(LM_AXIS),
        landmark_inlier=P(LM_AXIS),
        chi2_threshold=P(),
        cost=P(),
    )

    fn = functools.partial(
        schur_lm.lm_optimize, iters=iters, axis_name=LM_AXIS, **kwargs
    )
    sharded = shard_map(
        lambda p, k: fn(p, k),
        mesh=mesh,
        in_specs=(_PROBLEM_SPECS, P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sharded)(problem, K)


def distributed_pose_only(
    problem: schur_lm.BAProblem,
    K: jnp.ndarray,
    mesh: Mesh,
    *,
    iters: int,
    **kwargs,
) -> pose_only_mod.PoseOnlyResult:
    out_specs = pose_only_mod.PoseOnlyResult(
        T_c_w=P(),
        chi2_edges=P(LM_AXIS),
        landmark_inlier=P(LM_AXIS),
        chi2_threshold=P(),
        cost=P(),
    )
    fn = functools.partial(
        pose_only_mod.optimize_pose_only, iters=iters, axis_name=LM_AXIS, **kwargs
    )
    sharded = shard_map(
        lambda p, k: fn(p, k),
        mesh=mesh,
        in_specs=(_PROBLEM_SPECS, P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sharded)(problem, K)
