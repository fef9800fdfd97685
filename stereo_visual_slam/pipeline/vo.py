"""The host-orchestrated SLAM driver — the reference-sequenced TEST ORACLE.

Production runs use pipeline/chunked.py (the device-resident chunked core,
the CLI default); this driver keeps the map and state machine on the host
in exact reference sequencing and is what equivalence tests compare the
fast path against (tests/test_chunked.py, tests/test_failure_paths.py).

Host-side orchestration of the jitted device programs, mirroring the control
flow of the reference:

  * state machine Init -> Track -> Lost with a 10-failure fuse
    (VO::pipeline, visual_odometry.cpp:649-706),
  * motion sanity check and keyframe rule evaluated ON DEVICE inside the
    fused per-frame step (models/vslam.py make_full_step),
  * on rejection the previous frame is KEPT so the matcher gate and motion
    gate scale with the growing frame gap (visual_odometry.cpp:239, :328),
  * per inserted keyframe, the complete BA schedule of run_vslam.cpp:58-71
    runs as ONE device dispatch (ba/schedule.py),
  * backend -> frontend feedback: tracking restarts from the BA-optimized
    pose of the last keyframe (visual_odometry.cpp:553-556),
  * evicted keyframes stream to the trajectory writer (map.cpp:119-122).

Pipelining: `lookahead=1` dispatches the next frame's fused step BEFORE
syncing the previous frame's scalars — the device state chains on-device
(the constant-velocity prior lives in the state), so host round-trip
latency overlaps compute. Costs of the lookahead: keyframe bookkeeping, BA
feedback and the Lost fuse lag one frame, and a frame following a rejected
frame uses a 1-too-small matcher gate. PnP estimates absolute poses from
landmark coordinates, so the lag does not accumulate error. `lookahead=0`
(default) gives exact reference sequencing.
"""

from __future__ import annotations

import collections
import enum
import time
from typing import Deque, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_visual_slam.ba import schedule as ba_schedule
from stereo_visual_slam.mapping.store import Keyframe, MapStore
from stereo_visual_slam.models import frontend as frontend_mod
from stereo_visual_slam.models import vslam
from stereo_visual_slam.pipeline.trajectory import TrajectoryWriter
from stereo_visual_slam.utils.config import Config


class TrackState(enum.Enum):
    INIT = 0
    TRACK = 1
    LOST = 2


class VisualOdometry:
    def __init__(
        self,
        config: Config,
        pose_path: Optional[str] = None,
        seed: int = 0,
        enable_ba: bool = True,
        lookahead: int = 0,
    ):
        self.config = config
        self.extract = frontend_mod.make_extractor(config)
        self.full_step = vslam.make_full_step(config, self.extract)
        _, self.keyframe_update = vslam.make_tracker(config)
        self.run_schedule = ba_schedule.make_ba_schedule(config.ba)
        self.map = MapStore(config)
        self.writer = TrajectoryWriter(pose_path) if pose_path else None
        self.enable_ba = enable_ba
        self.lookahead = lookahead

        cam = config.camera
        self.K = jnp.asarray(
            [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], jnp.float32
        )
        self.state = TrackState.INIT
        self.dstate: Optional[vslam.TrackState] = None
        self.last_frame_id = -1
        self.num_lost = 0
        self.next_lm_id = 0
        self.next_kf_id = 0
        self.rng = jax.random.PRNGKey(seed)
        self.estimates: Dict[int, np.ndarray] = {}
        self.stats: List[dict] = []
        # in-flight pipeline entries: (frame_id, state_handle, info_handle,
        # upgrades_handle)
        self.inflight: Deque[Tuple] = collections.deque()
        # deferred BA: (kf_ids, rows, result_handle) — fetched lazily so BA
        # compute overlaps subsequent frames
        self.pending_ba: Optional[Tuple] = None

    # ------------------------------------------------------------------
    def warmup(self):
        """Compile every device program on dummy data (the fused BA schedule
        is a large program; production runs pay its compilation here, not
        mid-sequence)."""
        cfg = self.config
        H, W = cfg.padded_hw
        images = jnp.zeros((2, H, W), jnp.uint8)
        st = vslam.empty_state(cfg)
        key = jax.random.PRNGKey(0)
        out = self.full_step(
            images, st, jnp.asarray(1.0, jnp.float32), key,
            jnp.asarray(0, jnp.int32),
        )
        jax.block_until_ready(out)
        feats = self.extract(
            images[0].astype(jnp.float32), images[1].astype(jnp.float32)
        )
        jax.block_until_ready(
            self.keyframe_update(st, feats, jnp.asarray(0, jnp.int32))
        )
        Kw = cfg.keyframe.window_size
        L = cfg.ba.max_landmarks
        inp = ba_schedule.ScheduleInput(
            T_c_w=jnp.tile(jnp.eye(4, dtype=jnp.float32), (Kw, 1, 1)),
            points=jnp.ones((L, 3), jnp.float32),
            uv=jnp.zeros((L, Kw, 2), jnp.float32),
            obs_mask=jnp.zeros((L, Kw), jnp.float32),
            inlier=jnp.ones((L,), jnp.float32),
            reliable=jnp.ones((L,), jnp.float32),
            present=jnp.ones((L,), jnp.float32),
            pose_mask=jnp.ones((Kw,), jnp.float32),
            fixed_pose=jnp.zeros((Kw,), jnp.float32).at[0].set(1.0),
        )
        np.asarray(self.run_schedule(inp, self.K).cost_full)

    # ------------------------------------------------------------------
    def _upload(self, left: np.ndarray, right: np.ndarray) -> jnp.ndarray:
        """One transfer for both images, uint8 (KITTI native depth)."""
        H, W = self.config.padded_hw
        h, w = left.shape
        stacked = np.zeros((2, H, W), np.uint8)
        stacked[0, :h, :w] = np.asarray(left, np.uint8)
        stacked[1, :h, :w] = np.asarray(right, np.uint8)
        return jnp.asarray(stacked)

    # ------------------------------------------------------------------
    def process(self, frame_id: int, left: np.ndarray, right: np.ndarray) -> dict:
        """Feed one stereo frame. With lookahead=0, returns this frame's
        stats; with lookahead>0, returns the stats of an earlier frame (or a
        {'state': 'pending'} record while the pipeline fills)."""
        t0 = time.perf_counter()
        if self.state == TrackState.INIT:
            rec = self._initialize(frame_id, left, right)
            rec["wall_s"] = time.perf_counter() - t0
            self.stats.append(rec)
            return rec
        if self.state == TrackState.LOST:
            return dict(frame_id=frame_id, state="lost", wall_s=0.0)

        self._submit(frame_id, left, right)
        if len(self.inflight) > self.lookahead:
            rec = self._collect()
        else:
            rec = dict(frame_id=frame_id, state="pending")
        rec["wall_s"] = time.perf_counter() - t0
        self.stats.append(rec)
        return rec

    def drain(self) -> List[dict]:
        """Collect all in-flight frames (call at end of sequence)."""
        out = []
        while self.inflight:
            rec = self._collect()
            self.stats.append(rec)
            out.append(rec)
        return out

    # ------------------------------------------------------------------
    def _initialize(self, frame_id: int, left, right) -> dict:
        """First frame: spawn landmarks from stereo, insert keyframe 0
        (VO::initialization, visual_odometry.cpp:491-545)."""
        images = self._upload(left, right)
        feats = self.extract(
            images[0].astype(jnp.float32), images[1].astype(jnp.float32)
        )
        st = vslam.empty_state(self.config)._replace(
            yx=feats.yx, signs=feats.signs
        )
        st, n_new, _ = self.keyframe_update(
            st, feats, jnp.asarray(self.next_lm_id, jnp.int32)
        )
        self.dstate = st
        self._register_keyframe(frame_id, st, upgrades=None)
        self.state = TrackState.TRACK
        self.last_frame_id = frame_id
        self.estimates[frame_id] = np.eye(4, dtype=np.float32)
        return dict(
            frame_id=frame_id,
            state="init",
            keyframe=True,
            n_landmarks=int(n_new),
        )

    # ------------------------------------------------------------------
    def _submit(self, frame_id: int, left, right):
        frame_gap = float(max(frame_id - self.last_frame_id, 1))
        images = self._upload(left, right)
        self.rng, key = jax.random.split(self.rng)
        new_state, info_d, upgrades = self.full_step(
            images,
            self.dstate,
            jnp.asarray(frame_gap, jnp.float32),
            key,
            jnp.asarray(self.next_lm_id, jnp.int32),
        )
        # reserve an id range for this frame's potential spawns so
        # lookahead-dispatched frames never collide
        self.next_lm_id += self.config.frontend.n_features
        self.dstate = new_state
        self.last_frame_id = frame_id
        # start host transfers NOW — by collect time (>= 1 frame later) the
        # data is on the host and device_get does not block
        for leaf in jax.tree.leaves(info_d):
            leaf.copy_to_host_async()
        upgrades.copy_to_host_async()
        for leaf in (
            new_state.yx,
            new_state.valid,
            new_state.lm_id,
            new_state.lm_pos,
            new_state.lm_reliable,
            new_state.T_c_w,
        ):
            leaf.copy_to_host_async()
        self.inflight.append((frame_id, new_state, info_d, upgrades))

    # ------------------------------------------------------------------
    def _collect(self) -> dict:
        cfg = self.config
        frame_id, state_h, info_d, upgrades = self.inflight.popleft()
        info = jax.device_get(info_d)   # the one blocking sync per frame
        self._apply_pending_ba()        # BA dispatched at an earlier keyframe

        if not bool(info.ok):
            self.num_lost += 1
            if self.num_lost > cfg.keyframe.max_lost:
                self.state = TrackState.LOST
            return dict(
                frame_id=frame_id,
                state="rejected" if self.state == TrackState.TRACK else "lost",
                n_matches=int(info.n_matches),
                n_inliers=int(info.n_inliers),
                twist=float(info.twist_norm),
            )

        self.num_lost = 0
        is_keyframe = bool(info.is_keyframe)
        ba_stats = {}
        if is_keyframe:
            self._register_keyframe(frame_id, state_h, upgrades)
            if self.enable_ba and self.map.n_keyframes() >= cfg.keyframe.window_size:
                ba_stats = self._run_ba()
        if is_keyframe:
            self.estimates[frame_id] = np.asarray(
                self.map.keyframes[self.map.current_keyframe_id].T_c_w
            )
        else:
            # pose rides along in the info fetch — no extra round trip
            self.estimates[frame_id] = np.asarray(info.T_c_w)

        self._drain_evicted()
        return dict(
            frame_id=frame_id,
            state="tracked",
            keyframe=is_keyframe,
            n_matches=int(info.n_matches),
            n_inliers=int(info.n_inliers),
            n_new_landmarks=int(info.n_new),
            twist=float(info.twist_norm),
            yaw=float(info.angle_y),
            **ba_stats,
        )

    # ------------------------------------------------------------------
    def _register_keyframe(self, frame_id: int, st, upgrades=None):
        """Pull the keyframe's feature table (one transfer) and update the
        arena map (VO::insert_key_frame bookkeeping,
        visual_odometry.cpp:358-427) with vectorized numpy."""
        fetch = (st.yx, st.valid, st.lm_id, st.lm_pos, st.lm_reliable, st.T_c_w)
        if upgrades is not None:
            fetch = fetch + (upgrades,)
        got = jax.device_get(fetch)
        yx, valid, lm_id, lm_pos, lm_rel, T_c_w = got[:6]
        upg = got[6] if upgrades is not None else None
        lm_id = lm_id.astype(np.int64).copy()
        valid = valid.copy()

        live = valid & (lm_id >= 0)
        known_rows = self.map.rows_of(lm_id)
        is_new = live & (known_rows < 0)
        if is_new.any():
            self.map.spawn(lm_id[is_new], lm_pos[is_new], lm_rel[is_new])

        rows = self.map.rows_of(lm_id)
        known = live & (rows >= 0)
        if upg is not None:
            up = known & upg & ~is_new
            if up.any():
                self.map.upgrade(rows[up], lm_pos[up])

        uv = np.stack([yx[:, 1], yx[:, 0]], axis=-1).astype(np.float32)
        kf = Keyframe(
            keyframe_id=self.next_kf_id,
            frame_id=frame_id,
            T_c_w=np.asarray(T_c_w, np.float32),
            rows=np.where(known, rows, -1).astype(np.int32),
            uv=uv,
            valid=known,
        )
        self.next_kf_id += 1
        self.map.insert_keyframe(kf)

    # ------------------------------------------------------------------
    def _run_ba(self) -> dict:
        """Dispatch the whole BA schedule as one async device call; results
        are fetched lazily at the next collect (_apply_pending_ba)."""
        asm = self.map.assemble_schedule_input()
        if asm is None:
            return {}
        arrays, kf_ids, rows = asm
        inp = ba_schedule.ScheduleInput(
            **{k: jnp.asarray(v) for k, v in arrays.items()}
        )
        handle = self.run_schedule(inp, self.K)
        for leaf in jax.tree.leaves(handle):
            leaf.copy_to_host_async()
        if self.lookahead > 0:
            self.pending_ba = (kf_ids, rows, handle)
            return dict(ba_dispatched=True)
        self.pending_ba = (kf_ids, rows, handle)
        return self._apply_pending_ba()

    def _apply_pending_ba(self) -> dict:
        if self.pending_ba is None:
            return {}
        kf_ids, rows, handle = self.pending_ba
        self.pending_ba = None
        res = jax.device_get(handle)
        nK = len(kf_ids)
        self.map.write_back_schedule(
            kf_ids, rows, res.T_c_w[:nK], res.inlier[: len(rows)]
        )
        # feed the optimized pose back into the live tracking state (only
        # meaningful when nothing newer is already in flight)
        T_opt = self.map.keyframes[self.map.current_keyframe_id].T_c_w
        if not self.inflight:
            self.dstate = self.dstate._replace(
                T_c_w=jnp.asarray(T_opt, jnp.float32)
            )
        # refresh per-frame estimates with the optimized window poses
        for kf in self.map.keyframes.values():
            self.estimates[kf.frame_id] = kf.T_c_w
        return dict(
            ba_cost=float(res.cost_full), pose_only_cost=float(res.cost_pose)
        )

    # ------------------------------------------------------------------
    def _drain_evicted(self):
        if self.writer is None:
            self.map.evicted.clear()
            return
        for kf in self.map.evicted:
            self.writer.write(kf.frame_id, kf.T_c_w)
        self.map.evicted.clear()

    def finish(self):
        """Flush in-flight frames + remaining keyframe poses
        (write_remaining_pose, map.cpp:198-204)."""
        self.drain()
        self._apply_pending_ba()
        self._drain_evicted()
        if self.writer is not None:
            for kf_id in sorted(self.map.keyframes.keys()):
                kf = self.map.keyframes[kf_id]
                self.writer.write(kf.frame_id, kf.T_c_w)
