"""Brute-force Hamming matcher with cross-check, ratio margin, and optional
motion-prediction gating.

Reference semantics: cv::BFMatcher(NORM_HAMMING, crosscheck=true) + distance
threshold d <= max(2 * min_d, 30 * frame_gap) (visual_odometry.cpp:219-251).

Descriptors are +-1 float vectors so the full N x M distance matrix is ONE
256-deep matmul (orb.hamming_from_signs);
cross-check is a row/col argmin mutual test; everything masked, static
shapes.

Robustness additions over the reference (both needed once the matcher
searches ALL raw corners instead of an ANMS subset):
  * second-best margin test — repeated structure (e.g. silhouette corners)
    produces near-duplicate descriptors; requiring the runner-up to be at
    least `margin` bits worse kills those ambiguous matches (Lowe's ratio
    test, absolute-margin form suited to small integer Hamming distances);
  * motion gate — candidate positions must lie within `search_radius` px of
    the location predicted by the motion prior (constant-velocity pose +
    landmark depth), the classic projection-guided matching of VO systems.
Both default on and are configurable; set margin=0 / radius=inf for strict
reference behavior.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from stereo_visual_slam.ops.orb import hamming_from_signs

_BIG = 1e9


class MatchResult(NamedTuple):
    idx_last: jnp.ndarray   # (M,) int32 — index into "last" features per match
    idx_curr: jnp.ndarray   # (M,) int32 — index into "current" features
    dist: jnp.ndarray       # (M,) f32 Hamming distance
    mask: jnp.ndarray       # (M,) bool valid-match mask
    # current-side view of the same matching: consumers that build
    # per-current-slot state use these GATHERS instead of scattering the
    # row-side results
    idx_last_of_curr: jnp.ndarray  # (N_curr,) int32 partner row per curr slot
    mask_curr: jnp.ndarray         # (N_curr,) bool — mutual + all row gates


@functools.partial(jax.jit, static_argnames=())
def match(
    signs_last: jnp.ndarray,
    valid_last: jnp.ndarray,
    signs_curr: jnp.ndarray,
    valid_curr: jnp.ndarray,
    frame_gap: jnp.ndarray,
    pred_yx: Optional[jnp.ndarray] = None,
    curr_yx: Optional[jnp.ndarray] = None,
    search_radius: Optional[jnp.ndarray] = None,
    *,
    base_gate: float = 30.0,
    min_dist_factor: float = 2.0,
    margin: float = 15.0,
) -> MatchResult:
    """Cross-checked Hamming matching between two padded descriptor sets.

    pred_yx: (N_last, 2) predicted (row, col) of each last feature in the
    current frame; with curr_yx and search_radius enables the motion gate.
    Returns one match slot per "last" feature (M = N_last), masked.
    """
    D = hamming_from_signs(signs_last, signs_curr)  # (N_last, N_curr)
    D = jnp.where(valid_last[:, None] & valid_curr[None, :], D, _BIG)

    if pred_yx is not None and curr_yx is not None and search_radius is not None:
        d2 = jnp.sum(
            (pred_yx[:, None, :].astype(jnp.float32)
             - curr_yx[None, :, :].astype(jnp.float32)) ** 2,
            axis=-1,
        )
        D = jnp.where(d2 <= search_radius * search_radius, D, _BIG)

    best_j = jnp.argmin(D, axis=1)                     # (N_last,)
    best_d = jnp.take_along_axis(D, best_j[:, None], axis=1)[:, 0]
    # second-best along the row (excluding the best column)
    n_curr = D.shape[1]
    cols = jnp.arange(n_curr)
    D_wo_best = jnp.where(cols[None, :] == best_j[:, None], _BIG, D)
    second_d = jnp.min(D_wo_best, axis=1)
    distinct = (second_d - best_d) >= margin

    best_i = jnp.argmin(D, axis=0)                     # (N_curr,)
    n_last = D.shape[0]
    rows = jnp.arange(n_last, dtype=best_i.dtype)
    mutual = best_i[best_j] == rows
    ok = mutual & (best_d < _BIG) & distinct

    # reference gate: d <= max(2 * min_d_over_matches, 30 * frame_gap)
    min_d = jnp.min(jnp.where(ok, best_d, _BIG))
    gate = jnp.maximum(min_dist_factor * min_d, base_gate * frame_gap)
    ok = ok & (best_d <= gate)

    # current-side view: curr slot j's partner is best_i[j]; the pair is the
    # SAME (i, j) the row side found whenever it is mutual, so gathering the
    # row mask gives identical semantics
    mutual_curr = best_j[best_i] == jnp.arange(n_curr, dtype=best_j.dtype)
    mask_curr = mutual_curr & ok[best_i]

    return MatchResult(
        idx_last=rows.astype(jnp.int32),
        idx_curr=best_j.astype(jnp.int32),
        dist=best_d,
        mask=ok,
        idx_last_of_curr=best_i.astype(jnp.int32),
        mask_curr=mask_curr,
    )
