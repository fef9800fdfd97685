"""The flagship model: per-frame tracking step as one jitted program.

This is the array-program reformulation of `VO::tracking`
(visual_odometry.cpp:547-646): descriptor matching against the previous
frame, landmark inheritance, PnP-RANSAC motion estimation, and inlier
bookkeeping — all inside a single jit with fixed shapes. The host only sees
a handful of scalars (inlier count, twist norm, yaw) with which it runs the
keyframe / sanity state machine.

Device state between frames is a `TrackState` table indexed by the current
frame's detection slots (0..N-1). Features are "alive" where `valid`; each
live feature carries the id and world position of its landmark — the
hash-map Feature/Landmark graph of the reference (types_def.hpp:17-121)
flattened into arrays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from stereo_visual_slam.geom import se3
from stereo_visual_slam.models.frontend import FrameFeatures
from stereo_visual_slam.ops import matcher as matcher_ops
from stereo_visual_slam.tracking import pnp
from stereo_visual_slam.utils.config import Config
from stereo_visual_slam.utils.hostconst import build_on_host


class TrackState(NamedTuple):
    yx: jnp.ndarray          # (N, 2) float32 full-res pixel coords
    valid: jnp.ndarray       # (N,) bool — live feature
    signs: jnp.ndarray       # (N, 256) descriptor
    lm_id: jnp.ndarray       # (N,) int32 landmark id, -1 if none
    lm_pos: jnp.ndarray      # (N, 3) landmark world position
    lm_reliable: jnp.ndarray  # (N,) bool landmark has reliable depth
    T_c_w: jnp.ndarray       # (4, 4) pose of this frame
    T_c_l: jnp.ndarray       # (4, 4) last relative motion (velocity prior)


class TrackInfo(NamedTuple):
    n_matches: jnp.ndarray   # () int32 gated matches fed to PnP
    n_inliers: jnp.ndarray   # () int32 PnP inliers (num_inliers_ analog)
    twist_norm: jnp.ndarray  # () ||log(T_c_l)||
    angle_y: jnp.ndarray     # () |yaw(T_c_l)|
    T_c_l: jnp.ndarray       # (4, 4) last -> current


class StepInfo(NamedTuple):
    """Everything the host needs from one fused frame step — ONE transfer."""

    n_matches: jnp.ndarray
    n_inliers: jnp.ndarray
    twist_norm: jnp.ndarray
    angle_y: jnp.ndarray
    T_c_l: jnp.ndarray
    ok: jnp.ndarray          # () bool — motion sanity verdict
    is_keyframe: jnp.ndarray  # () bool
    n_new: jnp.ndarray       # () int32 landmarks spawned (0 if not keyframe)
    T_c_w: jnp.ndarray       # (4, 4) this frame's estimated pose


def empty_state(config: Config) -> TrackState:
    n = config.frontend.max_raw_keypoints
    bits = config.frontend.descriptor_bits
    return TrackState(
        yx=jnp.zeros((n, 2), jnp.float32),
        valid=jnp.zeros((n,), bool),
        signs=jnp.zeros((n, bits), jnp.float32),
        lm_id=-jnp.ones((n,), jnp.int32),
        lm_pos=jnp.zeros((n, 3), jnp.float32),
        lm_reliable=jnp.zeros((n,), bool),
        T_c_w=jnp.eye(4, dtype=jnp.float32),
        T_c_l=jnp.eye(4, dtype=jnp.float32),
    )


@build_on_host
def make_tracker(config: Config):
    """Build jitted (track_step, keyframe_update) closed over config."""
    cam = config.camera
    mc = config.matcher
    pc = config.pnp
    K = jnp.asarray(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], jnp.float32
    )
    n = config.frontend.max_raw_keypoints

    @jax.jit
    def track_step(
        curr: FrameFeatures,
        prev: TrackState,
        T_init: jnp.ndarray,
        frame_gap: jnp.ndarray,
        rng_key: jnp.ndarray,
    ):
        # motion-guided matching: predict each tracked landmark's position in
        # the current frame from the constant-velocity prior
        Xc = se3.act(T_init, prev.lm_pos)
        z = jnp.maximum(Xc[:, 2], 1e-3)
        pred_yx = jnp.stack(
            [
                K[1, 1] * Xc[:, 1] / z + K[1, 2],   # row (v)
                K[0, 0] * Xc[:, 0] / z + K[0, 2],   # col (u)
            ],
            axis=-1,
        )
        m = matcher_ops.match(
            prev.signs,
            prev.valid,
            curr.signs,
            curr.valid,
            frame_gap,
            pred_yx=pred_yx,
            curr_yx=curr.yx,
            search_radius=mc.search_radius * frame_gap,
            base_gate=mc.base_gate,
            min_dist_factor=mc.min_dist_factor,
            margin=mc.margin,
        )
        # one PnP correspondence per match slot (slot = prev feature index)
        pts_w = prev.lm_pos
        uv = jnp.stack(
            [
                curr.yx[m.idx_curr][:, 1].astype(jnp.float32),
                curr.yx[m.idx_curr][:, 0].astype(jnp.float32),
            ],
            axis=-1,
        )
        corr_valid = m.mask & prev.valid & (prev.lm_id >= 0)

        res = pnp.solve_pnp_ransac(
            pts_w,
            uv,
            corr_valid,
            K,
            T_init,
            rng_key,
            n_hypotheses=pc.n_hypotheses,
            sample_size=pc.sample_size,
            inlier_px=pc.inlier_px,
            gn_iters_hypothesis=pc.gn_iters_hypothesis,
            gn_iters_refine=pc.gn_iters_refine,
            huber_px=pc.huber_px,
            prior_spread=pc.prior_spread * frame_gap,
        )

        # gather match results into current-frame detection slots via the
        # matcher's current-side view (gathers, not scatters)
        src = m.idx_last_of_curr                      # (N,) prev slot per curr
        tracked = m.mask_curr & res.inlier_mask[src]  # (N,) per curr slot
        lm_id = jnp.where(tracked, prev.lm_id[src], -1)
        lm_pos = jnp.where(tracked[:, None], prev.lm_pos[src], 0.0)
        lm_rel = tracked & prev.lm_reliable[src]

        T_c_l = se3.compose(res.T_c_w, se3.inverse(prev.T_c_w))
        new_state = TrackState(
            yx=curr.yx,
            valid=tracked,
            signs=curr.signs,
            lm_id=lm_id,
            lm_pos=lm_pos,
            lm_reliable=lm_rel,
            T_c_w=res.T_c_w,
            T_c_l=T_c_l,
        )
        info = TrackInfo(
            n_matches=jnp.sum(corr_valid.astype(jnp.int32)),
            n_inliers=res.n_inliers,
            twist_norm=jnp.linalg.norm(se3.log(T_c_l)),
            angle_y=se3.angle_y(T_c_l),
            T_c_l=T_c_l,
        )
        return new_state, info

    @jax.jit
    def keyframe_update(
        state: TrackState, curr: FrameFeatures, next_lm_id: jnp.ndarray
    ):
        """Spawn landmarks for untracked features with valid depth and
        upgrade tracked landmarks that just became reliable
        (VO::insert_key_frame, visual_odometry.cpp:348-432)."""
        T_w_c = se3.inverse(state.T_c_w)
        pts_w_new = se3.act(T_w_c, curr.pts_cam)      # (N, 3)

        # upgrade: tracked landmark not yet reliable, current depth reliable
        upgrade = state.valid & (~state.lm_reliable) & curr.reliable
        lm_pos = jnp.where(upgrade[:, None], pts_w_new, state.lm_pos)
        lm_rel = state.lm_reliable | upgrade

        # spawn: untracked ANMS-selected detection with valid depth
        # (same-slot tracked features ARE the exact-coordinate dedup of
        # visual_odometry.cpp:385-401)
        new = (~state.valid) & curr.valid & curr.spawn_mask & curr.depth_valid
        offsets = jnp.cumsum(new.astype(jnp.int32)) - 1
        new_ids = next_lm_id + offsets
        lm_id = jnp.where(new, new_ids, state.lm_id)
        lm_pos = jnp.where(new[:, None], pts_w_new, lm_pos)
        lm_rel = jnp.where(new, curr.reliable, lm_rel)
        valid = state.valid | new

        n_new = jnp.sum(new.astype(jnp.int32))
        out = TrackState(
            yx=state.yx,
            valid=valid,
            signs=state.signs,
            lm_id=lm_id,
            lm_pos=lm_pos,
            lm_reliable=lm_rel,
            T_c_w=state.T_c_w,
            T_c_l=state.T_c_l,
        )
        return out, n_new, upgrade

    return track_step, keyframe_update


def make_full_step(config: Config, extract):
    """The whole per-frame program as ONE dispatch: feature extraction,
    matching, PnP, motion sanity check, keyframe decision, and (branchless)
    keyframe landmark spawning. The host receives a small `StepInfo` and the
    already-selected next state — 1 upload + 1 dispatch + 1 small fetch per
    frame instead of dozens.

    Sanity + keyframe rules evaluated on device:
      ok    = inliers >= 10  and  ||log(T_c_l)|| <= 5 * frame_gap
              (check_motion_estimation, visual_odometry.cpp:316-346)
      is_kf = ok and not (inliers >= 80 and |yaw| < 0.03)
              (insert_key_frame, visual_odometry.cpp:353)
    """
    track_step, keyframe_update = make_tracker(config)
    pc = config.pnp
    kc = config.keyframe

    @jax.jit
    def full_step(
        images: jnp.ndarray,       # (2, H, W) uint8 or f32 — left, right
        prev: TrackState,
        frame_gap: jnp.ndarray,
        rng_key: jnp.ndarray,
        next_lm_id: jnp.ndarray,
    ):
        # constant-velocity prior, computed ON DEVICE from the state's own
        # last relative motion — the host never needs to sync a pose to
        # dispatch the next frame, which enables lookahead pipelining.
        # Scaled by the frame gap: after g rejections the expected motion
        # is (T_c_l)^g (see slam_core.slam_frame_step).
        T_init = se3.compose(
            se3.exp(frame_gap * se3.log(prev.T_c_l)), prev.T_c_w
        )
        left = images[0].astype(jnp.float32)
        right = images[1].astype(jnp.float32)
        feats = extract(left, right)
        # stop XLA from fusing the extractor into the tracking consumers —
        # producer fusion would rematerialize image-sized chains inside the
        # PnP loops (measured 10x slowdown without the barrier)
        feats = jax.lax.optimization_barrier(feats)
        tracked, tinfo = track_step(feats, prev, T_init, frame_gap, rng_key)

        ok = (tinfo.n_inliers >= pc.min_inliers) & (
            tinfo.twist_norm <= pc.max_twist * frame_gap
        )
        is_kf = ok & ~(
            (tinfo.n_inliers >= kc.min_inliers_skip)
            & (tinfo.angle_y < kc.max_yaw_skip)
        )

        kf_state, n_new, upgrades = keyframe_update(tracked, feats, next_lm_id)

        def select(a, b, flag):
            return jax.tree.map(
                lambda x, y: jnp.where(
                    flag.reshape((1,) * x.ndim) if x.ndim else flag, x, y
                ),
                a,
                b,
            )

        state = select(kf_state, tracked, is_kf)
        state = select(state, prev, ok)

        info = StepInfo(
            n_matches=tinfo.n_matches,
            n_inliers=tinfo.n_inliers,
            twist_norm=tinfo.twist_norm,
            angle_y=tinfo.angle_y,
            T_c_l=tinfo.T_c_l,
            ok=ok,
            is_keyframe=is_kf,
            n_new=jnp.where(is_kf, n_new, 0),
            T_c_w=state.T_c_w,
        )
        return state, info, upgrades

    return full_step
