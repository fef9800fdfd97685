"""Checkpoint / resume: map-state snapshots.

The reference has no reload path (SURVEY.md §5 — its closest analog is the
incremental pose flush at eviction, map.cpp:119-122). Here the entire SLAM
state — landmark arena, keyframe window, tracking counters, and the device
TrackState — serializes to one compressed npz, so a run can stop and resume
mid-sequence (or a mapping session can be archived and reloaded for
localization-only use).
"""

from __future__ import annotations

import numpy as np

from stereo_visual_slam.mapping.store import Keyframe

SNAPSHOT_VERSION = 1


def save_snapshot(vo, path: str):
    """Serialize a VisualOdometry instance's full state (drains the pipeline
    first so nothing is in flight)."""
    import jax

    vo.drain()
    vo._apply_pending_ba()
    m = vo.map
    kf_ids = sorted(m.keyframes.keys())
    data = dict(
        version=np.int64(SNAPSHOT_VERSION),
        # arena
        pos=m.pos,
        reliable=m.reliable,
        inlier=m.inlier,
        obs_count=m.obs_count,
        row_id=m.row_id,
        alive=m.alive,
        id_to_row=m.id_to_row,
        # keyframes (stacked)
        kf_ids=np.array(kf_ids, np.int64),
        kf_frame_ids=np.array(
            [m.keyframes[k].frame_id for k in kf_ids], np.int64
        ),
        kf_T=np.stack([m.keyframes[k].T_c_w for k in kf_ids])
        if kf_ids
        else np.zeros((0, 4, 4), np.float32),
        kf_rows=np.stack([m.keyframes[k].rows for k in kf_ids])
        if kf_ids
        else np.zeros((0, 0), np.int32),
        kf_uv=np.stack([m.keyframes[k].uv for k in kf_ids])
        if kf_ids
        else np.zeros((0, 0, 2), np.float32),
        kf_valid=np.stack([m.keyframes[k].valid for k in kf_ids])
        if kf_ids
        else np.zeros((0, 0), bool),
        current_keyframe_id=np.int64(m.current_keyframe_id),
        # VO counters
        next_lm_id=np.int64(vo.next_lm_id),
        next_kf_id=np.int64(vo.next_kf_id),
        last_frame_id=np.int64(vo.last_frame_id),
        num_lost=np.int64(vo.num_lost),
        vo_state=np.int64(vo.state.value),
        rng=np.asarray(vo.rng),
    )
    # device tracking state
    if vo.dstate is not None:
        st = jax.device_get(vo.dstate)
        for name, arr in st._asdict().items():
            data[f"dstate_{name}"] = np.asarray(arr)
    np.savez_compressed(path, **data)


def load_snapshot(vo, path: str):
    """Restore state saved by save_snapshot into a VisualOdometry built with
    the same Config."""
    import jax.numpy as jnp

    from stereo_visual_slam.models import vslam
    from stereo_visual_slam.pipeline.vo import TrackState as VoState

    z = np.load(path, allow_pickle=False)
    assert int(z["version"]) == SNAPSHOT_VERSION

    m = vo.map
    m.pos = z["pos"].copy()
    m.reliable = z["reliable"].copy()
    m.inlier = z["inlier"].copy()
    m.obs_count = z["obs_count"].copy()
    m.row_id = z["row_id"].copy()
    m.alive = z["alive"].copy()
    m.id_to_row = z["id_to_row"].copy()
    m._free = [int(r) for r in np.nonzero(~m.alive)[0][::-1]]
    m.keyframes = {}
    for i, kf_id in enumerate(z["kf_ids"]):
        m.keyframes[int(kf_id)] = Keyframe(
            keyframe_id=int(kf_id),
            frame_id=int(z["kf_frame_ids"][i]),
            T_c_w=z["kf_T"][i].copy(),
            rows=z["kf_rows"][i].copy(),
            uv=z["kf_uv"][i].copy(),
            valid=z["kf_valid"][i].copy(),
        )
    m.current_keyframe_id = int(z["current_keyframe_id"])

    vo.next_lm_id = int(z["next_lm_id"])
    vo.next_kf_id = int(z["next_kf_id"])
    vo.last_frame_id = int(z["last_frame_id"])
    vo.num_lost = int(z["num_lost"])
    vo.state = VoState(int(z["vo_state"]))
    vo.rng = jnp.asarray(z["rng"])

    if "dstate_yx" in z:
        fields = {
            name: jnp.asarray(z[f"dstate_{name}"])
            for name in vslam.TrackState._fields
        }
        vo.dstate = vslam.TrackState(**fields)
