"""Sliding-window keyframe/landmark map — arena-based, vectorized host store.

Replaces the reference's `Map` (map.hpp:15-81, map.cpp): hash maps of
keyframes and landmarks, observation back-links, the 10-keyframe sliding
window with distance-based eviction (map.cpp:48-130) and landmark GC
(map.cpp:132-152).

Design: landmarks live in a flat ARENA of parallel numpy arrays (position,
reliable, inlier, observation count) with a free-list; landmark ids map to
arena rows through a dense id->row table. Every mutation the pipeline
performs per keyframe (spawn, observe, upgrade, evict, GC) is a vectorized
numpy operation over row index arrays — no per-feature Python loops, no
per-landmark objects. Keyframes store their features as fixed-size
slot-indexed arrays referencing arena rows.

`assemble_schedule_input` produces the dense (L, K) window consumed by the
single-dispatch BA schedule (ba/schedule.py) in one pass of fancy indexing.

The same layout is implemented natively in native/src/mapstore.cpp
(bound as utils.native.NativeMapStore) for the production host runtime;
this module is the reference implementation and test oracle for it
(tests/test_native.py asserts bit-for-bit equivalence).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from stereo_visual_slam.utils.config import Config


def se3_log_norm(T: np.ndarray) -> float:
    """||log(T)|| for a 4x4 rigid transform (numpy, host)."""
    R = T[:3, :3]
    t = T[:3, 3]
    cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = float(np.arccos(cos_t))
    if theta < 1e-6:
        w = np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        ) * 0.5
        v = t
    else:
        w = (
            np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
            * theta
            / (2.0 * np.sin(theta))
        )
        wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        t2 = theta * theta
        Vinv = (
            np.eye(3)
            - 0.5 * wx
            + (1.0 - theta * np.cos(theta / 2.0) / (2.0 * np.sin(theta / 2.0)))
            / t2
            * (wx @ wx)
        )
        v = Vinv @ t
    return float(np.sqrt(np.sum(v * v) + np.sum(w * w)))


@dataclasses.dataclass
class Keyframe:
    keyframe_id: int
    frame_id: int
    T_c_w: np.ndarray        # (4, 4)
    rows: np.ndarray         # (N,) int32 arena rows, -1 where no landmark
    uv: np.ndarray           # (N, 2) f32 pixel (x, y)
    valid: np.ndarray        # (N,) bool


class MapStore:
    """Arena-backed sliding-window map."""

    ARENA_CAP = 1 << 15          # 32768 live landmarks (window holds < 5k)
    ID_TABLE_CHUNK = 1 << 20     # id->row table growth quantum

    def __init__(self, config: Config):
        self.config = config
        cap = self.ARENA_CAP
        self.pos = np.zeros((cap, 3), np.float32)
        self.reliable = np.zeros(cap, bool)
        self.inlier = np.zeros(cap, bool)
        self.obs_count = np.zeros(cap, np.int32)
        self.row_id = np.full(cap, -1, np.int64)       # arena row -> lm id
        self.alive = np.zeros(cap, bool)
        self._free = list(range(cap - 1, -1, -1))      # pop() yields 0 first
        self.id_to_row = np.full(self.ID_TABLE_CHUNK, -1, np.int32)

        self.keyframes: Dict[int, Keyframe] = {}
        self.current_keyframe_id: int = -1
        self.evicted: List[Keyframe] = []

    # ------------------------------------------------------------- landmarks
    def _ensure_id_table(self, max_id: int):
        if max_id >= len(self.id_to_row):
            grow = (
                (max_id // self.ID_TABLE_CHUNK + 1) * self.ID_TABLE_CHUNK
            )
            new = np.full(grow, -1, np.int32)
            new[: len(self.id_to_row)] = self.id_to_row
            self.id_to_row = new

    def spawn(self, ids: np.ndarray, pos: np.ndarray, reliable: np.ndarray):
        """Insert new landmarks (vectorized). ids int64 (M,)."""
        m = len(ids)
        if m == 0:
            return
        if m > len(self._free):
            raise RuntimeError("landmark arena exhausted")
        rows = np.array([self._free.pop() for _ in range(m)], np.int32)
        self.pos[rows] = pos
        self.reliable[rows] = reliable
        self.inlier[rows] = True
        self.obs_count[rows] = 0
        self.row_id[rows] = ids
        self.alive[rows] = True
        self._ensure_id_table(int(ids.max()))
        self.id_to_row[ids] = rows

    def rows_of(self, ids: np.ndarray) -> np.ndarray:
        """(M,) int32 rows, -1 for unknown/GC'd ids."""
        ids = np.asarray(ids, np.int64)
        out = np.full(len(ids), -1, np.int32)
        ok = (ids >= 0) & (ids < len(self.id_to_row))
        out[ok] = self.id_to_row[ids[ok]]
        return out

    def upgrade(self, rows: np.ndarray, pos: np.ndarray):
        """Landmarks whose depth just became reliable
        (visual_odometry.cpp:395-399)."""
        if len(rows):
            self.pos[rows] = pos
            self.reliable[rows] = True

    # ------------------------------------------------------------- keyframes
    def insert_keyframe(self, kf: Keyframe):
        """Insert + count observations; evict if the window overflows
        (Map::insert_keyframe, map.cpp:13-33)."""
        self.keyframes[kf.keyframe_id] = kf
        self.current_keyframe_id = kf.keyframe_id
        rows = kf.rows[kf.valid & (kf.rows >= 0)]
        self.obs_count[rows] += 1
        if len(self.keyframes) > self.config.keyframe.window_size:
            self.remove_keyframe()

    def remove_keyframe(self):
        """Distance rule of map.cpp:48-130: evict the CLOSEST keyframe to the
        current one if its distance < 0.2, else the FARTHEST."""
        cur = self.keyframes[self.current_keyframe_id]
        T_w_cur = np.linalg.inv(cur.T_c_w)
        min_d, max_d = np.inf, -np.inf
        min_id = max_id = None
        for kf_id, kf in self.keyframes.items():
            if kf_id == self.current_keyframe_id:
                continue
            d = se3_log_norm(kf.T_c_w @ T_w_cur)
            if d < min_d:
                min_d, min_id = d, kf_id
            if d > max_d:
                max_d, max_id = d, kf_id
        if min_id is None:
            return
        victim_id = (
            min_id if min_d < self.config.keyframe.eviction_min_dist else max_id
        )
        victim = self.keyframes.pop(victim_id)
        rows = victim.rows[victim.valid & (victim.rows >= 0)]
        self.obs_count[rows] -= 1
        self.evicted.append(victim)
        self.clean_map()

    def clean_map(self):
        """GC landmarks with no remaining observations (map.cpp:132-152)."""
        dead = np.nonzero(self.alive & (self.obs_count <= 0))[0]
        if len(dead) == 0:
            return
        self.alive[dead] = False
        self.id_to_row[self.row_id[dead]] = -1
        self.row_id[dead] = -1
        self._free.extend(int(r) for r in dead)

    # ------------------------------------------------------------- queries
    def n_keyframes(self) -> int:
        return len(self.keyframes)

    def n_landmarks(self) -> int:
        return int(self.alive.sum())

    # ------------------------------------------------------------- BA I/O
    def assemble_schedule_input(self) -> Optional[Tuple[dict, np.ndarray, np.ndarray]]:
        """Dense (L, K) window for the device BA schedule.

        Returns (arrays dict matching ba.schedule.ScheduleInput, kf_ids (K,),
        rows (L,)) or None. Landmark rows = union of rows observed by active
        keyframes (the schedule applies inlier/reliable filtering on device).
        """
        cfg = self.config
        Kw = cfg.keyframe.window_size
        L = cfg.ba.max_landmarks
        kf_ids = np.array(sorted(self.keyframes.keys()), dtype=np.int64)
        nK = len(kf_ids)
        if nK == 0:
            return None

        all_rows = np.concatenate(
            [
                kf.rows[kf.valid & (kf.rows >= 0)]
                for kf in self.keyframes.values()
            ]
        )
        sel = np.unique(all_rows)
        if len(sel) == 0:
            return None
        if len(sel) > L:
            sel = sel[:L]
        nL = len(sel)

        T = np.tile(np.eye(4, dtype=np.float32), (Kw, 1, 1))
        uv = np.zeros((L, Kw, 2), np.float32)
        obs = np.zeros((L, Kw), np.float32)
        pose_mask = np.zeros((Kw,), np.float32)
        fixed = np.zeros((Kw,), np.float32)

        pts = np.zeros((L, 3), np.float32)
        pts[:nL] = self.pos[sel]
        inlier = np.zeros((L,), np.float32)
        inlier[:nL] = self.inlier[sel]
        reliable = np.zeros((L,), np.float32)
        reliable[:nL] = self.reliable[sel]
        present = np.zeros((L,), np.float32)
        present[:nL] = 1.0

        for k, kf_id in enumerate(kf_ids):
            kf = self.keyframes[int(kf_id)]
            T[k] = kf.T_c_w
            pose_mask[k] = 1.0
            vm = kf.valid & (kf.rows >= 0)
            rows = kf.rows[vm]
            idx = np.searchsorted(sel, rows)
            ok = (idx < nL) & (sel[np.minimum(idx, nL - 1)] == rows)
            uv[idx[ok], k] = kf.uv[vm][ok]
            obs[idx[ok], k] = 1.0

        if cfg.ba.fix_oldest_pose:
            fixed[0] = 1.0

        arrays = dict(
            T_c_w=T,
            points=pts,
            uv=uv,
            obs_mask=obs,
            inlier=inlier,
            reliable=reliable,
            present=present,
            pose_mask=pose_mask,
            fixed_pose=fixed,
        )
        return arrays, kf_ids, sel

    def write_back_schedule(
        self,
        kf_ids: np.ndarray,
        rows: np.ndarray,
        T_c_w: np.ndarray,
        inlier: np.ndarray,
    ):
        """Apply BA schedule results: optimized poses + inlier verdicts."""
        for i, kf_id in enumerate(kf_ids):
            kf = self.keyframes.get(int(kf_id))
            if kf is not None:
                kf.T_c_w = np.asarray(T_c_w[i], np.float32)
        live = self.alive[rows]
        self.inlier[rows[live]] = inlier[: len(rows)][live]
