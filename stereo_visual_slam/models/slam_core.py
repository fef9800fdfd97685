"""Device-resident SLAM core: the ENTIRE system as one scanned XLA program.

The host choreography of pipeline/vo.py pays a host<->device round trip per
frame for state it does not need: the map, the BA schedule, eviction, and
the tracking state machine are all data-flow on fixed-shape arrays. This
module keeps ALL of it in device memory:

  * `MapState` — the sliding-window keyframe/landmark map of the reference
    (map.hpp:15-81) as a landmark ARENA (L rows) plus a dense (L, Kw)
    observation grid. The arena row index IS the landmark identity (the
    reference's hash-map ids, map.cpp:35-46, become row numbers); rows free
    themselves when their observations vanish (clean_map, map.cpp:132-152).
  * `slam_frame_step` — per frame: tracking (match + PnP + sanity), the
    keyframe rule, keyframe insertion with distance-based eviction
    (map.cpp:48-130), the 4-pass BA schedule of run_vslam.cpp:58-71, and
    the BA->tracking pose feedback (visual_odometry.cpp:553-556) — one
    fused device program, no host in the loop.
  * `make_chunk_step` — lax.scan of the frame step over a CHUNK of frames:
    the host uploads B images, dispatches once, and fetches one small
    per-chunk record batch. Host<->device latency amortizes to RT/B.

Against pipeline/vo.py (kept as the reference-sequenced host loop and test
oracle) this is exact in semantics but *tighter*: BA feedback reaches the
very next frame (vo.py's lookahead trades that for pipelining), and the
frame gap / Lost fuse bookkeeping lives in the carry.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_visual_slam.ba import schedule as ba_schedule
from stereo_visual_slam.geom import se3
from stereo_visual_slam.models import frontend as frontend_mod
from stereo_visual_slam.models import vslam
from stereo_visual_slam.utils.config import Config
from stereo_visual_slam.utils.hostconst import build_on_host


class MapState(NamedTuple):
    """Sliding-window map, fully on device. L = ba.max_landmarks arena rows;
    Kw = keyframe.window_size ordered slots (0 oldest)."""

    pos: jnp.ndarray        # (L, 3) landmark world positions
    reliable: jnp.ndarray   # (L,) bool reliable_depth_ (types_def.hpp:117)
    inlier: jnp.ndarray     # (L,) bool is_inlier (optimization.cpp:254-266)
    obs_mask: jnp.ndarray   # (L, Kw) f32 1.0 where observed
    obs_uv: jnp.ndarray     # (L, Kw, 2) f32 pixel (u, v)
    kf_T: jnp.ndarray       # (Kw, 4, 4) keyframe poses T_c_w
    kf_frame_id: jnp.ndarray  # (Kw,) int32, -1 = empty slot
    kf_count: jnp.ndarray   # () int32 live keyframes


class FrameRecord(NamedTuple):
    """Everything the host learns about one frame — fetched once per chunk."""

    active: jnp.ndarray       # () bool — slot held a real frame (padding
    #                              slots in a short final chunk are inactive)
    frame_id: jnp.ndarray     # () int32
    tracked: jnp.ndarray      # () bool — motion check passed
    lost: jnp.ndarray         # () bool — system is in Lost state
    is_keyframe: jnp.ndarray  # () bool
    n_matches: jnp.ndarray    # () int32
    n_inliers: jnp.ndarray    # () int32
    n_new: jnp.ndarray        # () int32 landmarks spawned
    twist: jnp.ndarray        # () f32
    angle_y: jnp.ndarray      # () f32
    T_c_w: jnp.ndarray        # (4, 4) pose estimate for this frame
    ba_ran: jnp.ndarray       # () bool
    ba_cost: jnp.ndarray      # () f32 full-BA robust cost
    evict_valid: jnp.ndarray  # () bool — a keyframe was evicted this frame
    evict_frame_id: jnp.ndarray  # () int32
    evict_T: jnp.ndarray      # (4, 4) evicted keyframe pose (write_pose,
    #                              map.cpp:119-122)


class SlamCarry(NamedTuple):
    tstate: vslam.TrackState
    mstate: MapState
    last_frame_id: jnp.ndarray  # () int32 — last ACCEPTED frame (frame gap
    #                                grows across rejections, vo.cpp:239,328)
    num_lost: jnp.ndarray       # () int32 consecutive failures
    lost: jnp.ndarray           # () bool fuse blown (visual_odometry.cpp:663)


def empty_map(config: Config) -> MapState:
    L = config.ba.max_landmarks
    Kw = config.keyframe.window_size
    return MapState(
        pos=jnp.zeros((L, 3), jnp.float32),
        reliable=jnp.zeros((L,), bool),
        inlier=jnp.zeros((L,), bool),
        obs_mask=jnp.zeros((L, Kw), jnp.float32),
        obs_uv=jnp.zeros((L, Kw, 2), jnp.float32),
        kf_T=jnp.tile(jnp.eye(4, dtype=jnp.float32), (Kw, 1, 1)),
        kf_frame_id=-jnp.ones((Kw,), jnp.int32),
        kf_count=jnp.asarray(0, jnp.int32),
    )


def init_carry(config: Config) -> SlamCarry:
    return SlamCarry(
        tstate=vslam.empty_state(config),
        mstate=empty_map(config),
        last_frame_id=jnp.asarray(-1, jnp.int32),
        num_lost=jnp.asarray(0, jnp.int32),
        lost=jnp.asarray(False),
    )


def _allocate_rows(
    free: jnp.ndarray, want: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Assign the k-th wanting slot the k-th free arena row.

    free: (L,) bool rows available; want: (N,) bool slots requesting a row.
    Returns (row_per_slot (N,) int32 with -1 where not served, n_alloc).
    Replaces the host free-list (mapping/store.py) with a sort + gather.
    """
    L = free.shape[0]
    order = jnp.argsort(jnp.where(free, 0, 1), stable=True)    # free rows first
    n_free = jnp.sum(free.astype(jnp.int32))
    rank = jnp.cumsum(want.astype(jnp.int32)) - 1              # (N,)
    served = want & (rank < n_free)
    rows = jnp.where(served, order[jnp.clip(rank, 0, L - 1)], -1)
    return rows.astype(jnp.int32), jnp.sum(served.astype(jnp.int32))


@build_on_host
def make_feats_step(config: Config, mesh=None, depth_fn=None):
    """Build the per-frame tracking + mapping + BA device function over
    PRECOMPUTED features:

        (carry, feats: FrameFeatures, frame_id, key[, image])
            -> (carry', FrameRecord)

    Mirrors one iteration of the reference main loop (run_vslam.cpp:40-82)
    minus feature extraction — VO::tracking (visual_odometry.cpp:547-646) +
    conditional optimize_map x3 + optimize_pose_only. Extraction is
    per-frame independent and runs batched OUTSIDE the sequential scan
    (frontend.make_batch_extractor); everything here depends on the carry.

    With `depth_fn` (frontend.make_depth_stage), the feats' depth fields are
    expected EMPTY and stereo depth is computed lazily INSIDE the keyframe
    branch from the raw stereo `image` (passed as a 5th argument) — depth is
    only consumed by keyframe insertion (spawn/upgrade,
    visual_odometry.cpp:377-401), so the ~1.5 ms/frame sweep runs on the
    ~26 % of frames that need it. Values are bit-identical to the eager
    batch-extractor fields.

    With `mesh`, the per-keyframe BA schedule runs landmark-sharded across
    the mesh devices (ba/schedule.py shard_map path): the landmark arena is
    partitioned, each device reduces its Schur contributions, one psum per
    LM iteration. Tracking stays replicated (it is one frame's work); BA is
    where the window-scaling FLOPs live.
    """
    cam = config.camera
    pc = config.pnp
    kc = config.keyframe
    fe = config.frontend
    Kw = kc.window_size
    L = config.ba.max_landmarks
    N = fe.max_raw_keypoints
    K = jnp.asarray(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], jnp.float32
    )
    track_step, _ = vslam.make_tracker(config)
    run_schedule = ba_schedule.make_ba_schedule(config.ba, mesh=mesh)

    # ---------------------------------------------------------------- insert
    def insert_keyframe(tstate, mstate, feats, frame_id):
        """VO::insert_key_frame (visual_odometry.cpp:348-432) +
        Map::insert_keyframe / remove_keyframe / clean_map (map.cpp:13-152),
        all as array ops. Returns (tstate', mstate', n_new, evict_record)."""
        T_w_c = se3.inverse(tstate.T_c_w)
        pts_w_new = se3.act(T_w_c, feats.pts_cam)              # (N, 3)

        # --- upgrade: tracked landmark gains reliable depth (vo.cpp:385-401)
        upgrade = tstate.valid & (~tstate.lm_reliable) & feats.reliable
        lm_pos = jnp.where(upgrade[:, None], pts_w_new, tstate.lm_pos)
        lm_rel = tstate.lm_reliable | upgrade

        # --- spawn: untracked ANMS pick with valid depth (vo.cpp:402-422)
        # arena rows referenced by the live tracker must not be reallocated
        referenced = (
            jnp.zeros((L,), jnp.float32)
            .at[jnp.where(tstate.valid & (tstate.lm_id >= 0), tstate.lm_id, L)]
            .max(1.0, mode="drop")
        )
        occupied = jnp.max(mstate.obs_mask, axis=1) + referenced
        want = (~tstate.valid) & feats.valid & feats.spawn_mask & feats.depth_valid
        new_rows, n_new = _allocate_rows(occupied <= 0, want)
        spawned = new_rows >= 0
        lm_id = jnp.where(spawned, new_rows, tstate.lm_id)
        lm_pos = jnp.where(spawned[:, None], pts_w_new, lm_pos)
        lm_rel = jnp.where(spawned, feats.reliable, lm_rel)
        valid = tstate.valid | spawned

        # --- arena writes: spawn rows fully initialized; upgraded rows
        #     re-positioned + marked reliable (one scatter per field)
        srow = jnp.where(spawned, new_rows, L)                 # L = dropped
        urow = jnp.where(upgrade & ~spawned, tstate.lm_id, L)
        pos = mstate.pos.at[srow].set(pts_w_new, mode="drop")
        pos = pos.at[urow].set(pts_w_new, mode="drop")
        reliable = mstate.reliable.at[srow].set(
            feats.reliable, mode="drop"
        ).at[urow].set(True, mode="drop")
        inlier = mstate.inlier.at[srow].set(True, mode="drop")

        # --- window slot management: evict BEFORE inserting when full, by
        #     the reference rule relative to the NEW keyframe (map.cpp:48-130:
        #     current_keyframe_id is the just-inserted one)
        full = mstate.kf_count >= Kw
        T_w_new = T_w_c
        rel = jax.vmap(lambda Tk: se3.compose(Tk, T_w_new))(mstate.kf_T)
        d = jax.vmap(lambda M: jnp.linalg.norm(se3.log(M)))(rel)
        slot_live = jnp.arange(Kw) < mstate.kf_count
        d_min = jnp.where(slot_live, d, jnp.inf)
        d_max = jnp.where(slot_live, d, -jnp.inf)
        victim = jnp.where(
            jnp.min(d_min) < kc.eviction_min_dist,
            jnp.argmin(d_min),
            jnp.argmax(d_max),
        )
        evict_valid = full
        evict_frame_id = mstate.kf_frame_id[victim]
        evict_T = mstate.kf_T[victim]

        # shift-left permutation dropping the victim (identity when not full)
        idx = jnp.arange(Kw)
        perm = jnp.where(full & (idx >= victim), idx + 1, idx)
        perm = jnp.clip(perm, 0, Kw - 1)
        keep = jnp.where(full, idx < Kw - 1, idx < mstate.kf_count)
        obs_mask = jnp.where(keep[None, :], mstate.obs_mask[:, perm], 0.0)
        obs_uv = jnp.where(
            keep[None, :, None], mstate.obs_uv[:, perm], 0.0
        )
        kf_T = jnp.where(
            keep[:, None, None],
            mstate.kf_T[perm],
            jnp.eye(4, dtype=jnp.float32),
        )
        kf_frame_id = jnp.where(keep, mstate.kf_frame_id[perm], -1)
        slot = jnp.minimum(mstate.kf_count, Kw - 1)
        kf_count = jnp.minimum(mstate.kf_count + 1, Kw)

        # --- write the new keyframe's observation column (one 2D scatter)
        wrow = jnp.where(valid, lm_id, L)
        obs_mask = obs_mask.at[wrow, slot].set(1.0, mode="drop")
        uv = jnp.stack(
            [tstate.yx[:, 1], tstate.yx[:, 0]], axis=-1
        ).astype(jnp.float32)
        obs_uv = obs_uv.at[wrow, slot].set(uv, mode="drop")
        kf_T = kf_T.at[slot].set(tstate.T_c_w)
        kf_frame_id = kf_frame_id.at[slot].set(frame_id)

        tstate2 = tstate._replace(
            valid=valid, lm_id=lm_id, lm_pos=lm_pos, lm_reliable=lm_rel
        )
        mstate2 = MapState(
            pos=pos,
            reliable=reliable,
            inlier=inlier,
            obs_mask=obs_mask,
            obs_uv=obs_uv,
            kf_T=kf_T,
            kf_frame_id=kf_frame_id,
            kf_count=kf_count,
        )
        return tstate2, mstate2, n_new, (evict_valid, evict_frame_id, evict_T)

    # -------------------------------------------------------------------- BA
    def run_ba(tstate, mstate):
        """The full per-keyframe schedule (run_vslam.cpp:58-71) directly on
        the map arrays — the map IS the BA problem, no assembly."""
        present = (jnp.max(mstate.obs_mask, axis=1) > 0).astype(jnp.float32)
        inp = ba_schedule.ScheduleInput(
            T_c_w=mstate.kf_T,
            points=mstate.pos,
            uv=mstate.obs_uv,
            obs_mask=mstate.obs_mask,
            inlier=mstate.inlier.astype(jnp.float32),
            reliable=mstate.reliable.astype(jnp.float32),
            present=present,
            pose_mask=(jnp.arange(Kw) < mstate.kf_count).astype(jnp.float32),
            fixed_pose=jnp.zeros((Kw,), jnp.float32).at[0].set(
                1.0 if config.ba.fix_oldest_pose else 0.0
            ),
        )
        res = run_schedule(inp, K)
        mstate2 = mstate._replace(kf_T=res.T_c_w, inlier=res.inlier)
        # backend -> frontend feedback: tracking continues from the
        # optimized pose of the newest keyframe (visual_odometry.cpp:553-556)
        slot = mstate.kf_count - 1
        tstate2 = tstate._replace(T_c_w=res.T_c_w[slot])
        return tstate2, mstate2, res.cost_full

    # ------------------------------------------------------------------ step
    def slam_feats_step(carry: SlamCarry, feats, frame_id, key, image=None):
        tstate, mstate = carry.tstate, carry.mstate
        is_first = mstate.kf_count == 0
        frame_gap = jnp.maximum(
            (frame_id - carry.last_frame_id).astype(jnp.float32), 1.0
        )

        # constant-velocity prior SCALED BY THE FRAME GAP: after g rejected/
        # dropped frames the expected motion is (T_c_l)^g. The reference is
        # immune to this (solvePnPRansac is prior-free, vo.cpp:277); our
        # GN-from-prior hypotheses need the prior in the right basin.
        T_init = se3.compose(
            se3.exp(frame_gap * se3.log(tstate.T_c_l)), tstate.T_c_w
        )
        tracked_state, tinfo = track_step(
            feats, tstate, T_init, frame_gap, key
        )

        ok = (tinfo.n_inliers >= pc.min_inliers) & (
            tinfo.twist_norm <= pc.max_twist * frame_gap
        )
        is_kf = ok & ~(
            (tinfo.n_inliers >= kc.min_inliers_skip)
            & (tinfo.angle_y < kc.max_yaw_skip)
        )
        # first frame: identity pose, everything spawns, always a keyframe
        # (VO::initialization, visual_odometry.cpp:491-545)
        ok = ok | is_first
        is_kf = is_kf | is_first
        first_state = tstate._replace(
            yx=feats.yx,
            signs=feats.signs,
            valid=jnp.zeros((N,), bool),
            lm_id=-jnp.ones((N,), jnp.int32),
            T_c_w=jnp.eye(4, dtype=jnp.float32),
            T_c_l=jnp.eye(4, dtype=jnp.float32),
        )
        base = jax.tree.map(
            lambda f, t: jnp.where(
                is_first.reshape((1,) * f.ndim) if f.ndim else is_first, f, t
            ),
            first_state,
            tracked_state,
        )

        def do_keyframe(tstate_in, mstate_in):
            if depth_fn is not None:
                feats_kf = feats._replace(**depth_fn(image, feats))
            else:
                feats_kf = feats
            ts, ms, n_new, evict = insert_keyframe(
                tstate_in, mstate_in, feats_kf, frame_id
            )
            if config.ba.enable_ba:
                ts, ms, cost = jax.lax.cond(
                    ms.kf_count >= Kw,
                    lambda: run_ba(ts, ms),
                    lambda: (ts, ms, jnp.asarray(0.0, jnp.float32)),
                )
                ba_ran = ms.kf_count >= Kw
            else:
                # "Without Optimization" (README.md:92-94): the schedule is
                # absent from the program; inlier flags stay untouched
                cost = jnp.asarray(0.0, jnp.float32)
                ba_ran = jnp.asarray(False)
            return ts, ms, n_new, evict, ba_ran, cost

        def no_keyframe(tstate_in, mstate_in):
            return (
                tstate_in,
                mstate_in,
                jnp.asarray(0, jnp.int32),
                (
                    jnp.asarray(False),
                    jnp.asarray(-1, jnp.int32),
                    jnp.eye(4, dtype=jnp.float32),
                ),
                jnp.asarray(False),
                jnp.asarray(0.0, jnp.float32),
            )

        new_t, new_m, n_new, evict, ba_ran, ba_cost = jax.lax.cond(
            is_kf & ~carry.lost,
            do_keyframe,
            no_keyframe,
            base,
            mstate,
        )

        # rejection: keep the previous tracking state entirely so the gap
        # gates grow (visual_odometry.cpp:636 move_frame skipped)
        def sel(a, b, flag):
            return jax.tree.map(
                lambda x, y: jnp.where(
                    flag.reshape((1,) * x.ndim) if x.ndim else flag, x, y
                ),
                a,
                b,
            )

        accept = ok & ~carry.lost
        new_t = sel(new_t, tstate, accept)
        new_m = sel(new_m, mstate, accept)

        num_lost = jnp.where(accept, 0, carry.num_lost + 1)
        lost = carry.lost | (num_lost > kc.max_lost)

        record = FrameRecord(
            active=jnp.asarray(True),
            frame_id=frame_id,
            tracked=accept,
            lost=lost,
            is_keyframe=is_kf & accept,
            n_matches=tinfo.n_matches,
            n_inliers=tinfo.n_inliers,
            n_new=n_new,
            twist=tinfo.twist_norm,
            angle_y=tinfo.angle_y,
            T_c_w=new_t.T_c_w,
            ba_ran=ba_ran,
            ba_cost=ba_cost,
            evict_valid=evict[0],
            evict_frame_id=evict[1],
            evict_T=evict[2],
        )
        carry2 = SlamCarry(
            tstate=new_t,
            mstate=new_m,
            last_frame_id=jnp.where(
                accept, frame_id, carry.last_frame_id
            ).astype(jnp.int32),
            num_lost=num_lost.astype(jnp.int32),
            lost=lost,
        )
        return carry2, record

    return slam_feats_step


@build_on_host
def make_slam_step(config: Config, extract=None, mesh=None):
    """Per-frame device function over raw images (extraction included):

        (carry, image(2,H,W)u8, frame_id, key) -> (carry', FrameRecord)

    Composition of the per-frame extractor and `make_feats_step`. The
    production chunk driver uses the batched extractor + feats scan instead
    (make_chunk_step); this single-frame form serves profilers, oracles and
    the compile-check entry point.
    """
    if extract is None:
        extract = frontend_mod.make_extractor(config)
    feats_step = make_feats_step(config, mesh=mesh)

    def slam_frame_step(carry: SlamCarry, image, frame_id, key):
        left = image[0].astype(jnp.float32)
        right = image[1].astype(jnp.float32)
        feats = extract(left, right)
        feats = jax.lax.optimization_barrier(feats)
        return feats_step(carry, feats, frame_id, key)

    return slam_frame_step


def encode_chunk_buffer(stacked, fids, active):
    """Host-side: pack a chunk's images + sideband into ONE flat uint8
    buffer, so a chunk is one device_put instead of three (images, frame
    ids, active mask).

    stacked: (B, 2, H, W) uint8; fids: (B,) int32; active: (B,) bool.
    Returns (B*2*H*W + 5*B,) uint8.
    """
    import numpy as np

    return np.concatenate([
        np.ascontiguousarray(stacked, dtype=np.uint8).reshape(-1),
        np.ascontiguousarray(fids, dtype=np.int32).view(np.uint8),
        np.ascontiguousarray(active, dtype=np.uint8).reshape(-1),
    ])


def decode_chunk_buffer(buf, B, H, W):
    """Device-side inverse of encode_chunk_buffer (pure jnp, inside jit)."""
    n_img = B * 2 * H * W
    images = buf[:n_img].reshape(B, 2, H, W)
    fid_bytes = buf[n_img : n_img + 4 * B].reshape(B, 4).astype(jnp.int32)
    shifts = jnp.asarray([0, 8, 16, 24], jnp.int32)
    fids = jnp.sum(fid_bytes << shifts[None, :], axis=1)
    active = buf[n_img + 4 * B : n_img + 5 * B] > 0
    return images, fids, active


@functools.lru_cache(maxsize=8)
@build_on_host
def make_chunk_step_packed(config: Config, mesh=None, chunk: int = 8):
    """The production dispatch wrapper: one flat uint8 buffer in (images +
    sideband, encode_chunk_buffer), same semantics as make_chunk_step.
    Cached per (config, mesh, chunk) so driver instances share the jit."""
    step = make_chunk_step(config, mesh=mesh)
    H, W = config.padded_hw
    B = chunk

    @jax.jit
    def packed_step(carry: SlamCarry, buf, key):
        images, fids, active = decode_chunk_buffer(buf, B, H, W)
        return step(carry, images, fids, active, key)

    return packed_step


def make_chunk_step(config: Config, extract=None, mesh=None):
    """The production chunk program: batched extraction + tracking scan.
    ONE dispatch, ONE fetch for B frames — host round-trip latency
    amortizes to RT/B per frame.

        chunk_step(carry, images (B,2,H,W)u8, frame_ids (B,), active (B,)
                   bool, key) -> (carry', FrameRecord batch (B, ...))

    Structure: feature extraction is per-frame independent, so the B frames
    run through `frontend.make_batch_extractor` as one batched program (on a
    mesh: data-parallel over devices), and only the sequential part —
    matching, PnP, map insertion, BA — scans over the precomputed feature
    tables. Versus extracting inside the scan this halves the scanned
    program and lets the batch dimension fill the device.

    `active=False` slots are padding (a short final chunk padded to the
    static B): the carry passes through untouched and the record is flagged
    inactive — no recompilation for partial chunks. The per-frame RNG is
    `fold_in(key, frame_id)` with a run-constant key, so results are
    independent of how the sequence is cut into chunks (snapshot/resume at
    any frame boundary is bit-exact).
    """
    if extract is None:
        return _cached_chunk_step(config, mesh)
    return _build_chunk_step(config, extract, mesh)


@functools.lru_cache(maxsize=8)
def _cached_chunk_step(config: Config, mesh):
    """One compiled chunk program per (config, mesh) per process — multiple
    driver instances (tests, snapshot-resume runs) share the jit cache."""
    return _build_chunk_step(config, None, mesh)


@build_on_host
def _build_chunk_step(config: Config, extract, mesh):
    # lazy stereo: the batch extractor skips the per-frame depth sweep and
    # the scan's keyframe branch computes it from the raw frame instead
    # (frontend.make_depth_stage) — depth is only read at keyframes
    lazy_depth = extract is None and config.frontend.lazy_depth
    depth_fn = frontend_mod.make_depth_stage(config) if lazy_depth else None
    feats_step = make_feats_step(config, mesh=mesh, depth_fn=depth_fn)
    if extract is None:
        batch_extract = frontend_mod.make_batch_extractor(
            config, with_depth=not lazy_depth
        )
    else:
        # custom single-frame extractor (tests/oracles): vmap it
        def batch_extract(images):
            return jax.vmap(
                lambda im: extract(
                    im[0].astype(jnp.float32), im[1].astype(jnp.float32)
                )
            )(images)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        batch_sharding = NamedSharding(mesh, P(ba_schedule.LM_AXIS))
        replicated = NamedSharding(mesh, P())
    else:
        batch_sharding = replicated = None

    @jax.jit
    def chunk_step(carry: SlamCarry, images, frame_ids, active, key):
        if batch_sharding is not None and images.shape[0] % mesh.size == 0:
            # data-parallel extraction: each device owns B/n frames; the
            # feature tables are gathered back for the sequential scan
            images = jax.lax.with_sharding_constraint(images, batch_sharding)
        feats = batch_extract(images)
        if replicated is not None:
            feats = jax.tree.map(
                lambda a: jax.lax.with_sharding_constraint(a, replicated),
                feats,
            )
        feats = jax.lax.optimization_barrier(feats)
        if depth_fn is not None and replicated is not None:
            # the scan slices one frame per iteration; keep the images
            # replicated there so the lazy depth stage runs without
            # per-iteration cross-device gathers
            images = jax.lax.with_sharding_constraint(images, replicated)

        def body(c, xs):
            if depth_fn is not None:
                feat, img, fid, live = xs
            else:
                feat, fid, live = xs
                img = None
            k = jax.random.fold_in(key, fid)
            c2, rec = feats_step(c, feat, fid, k, img)
            c2 = jax.tree.map(
                lambda a, b: jnp.where(
                    live.reshape((1,) * a.ndim) if a.ndim else live, a, b
                ),
                c2,
                c,
            )
            rec = rec._replace(active=live)
            return c2, rec

        xs = (
            (feats, images, frame_ids, active)
            if depth_fn is not None
            else (feats, frame_ids, active)
        )
        return jax.lax.scan(body, carry, xs)

    return chunk_step
