"""Visualization — the rviz-free analog of VslamVisual (visualization.hpp).

The reference publishes three channels to rviz: the landmark point cloud
(`vslam/feature_map`, PointCloud2), the live camera pose (tf /map ->
/camera + blue CUBE markers for finalized poses) and the active keyframe
window (green MarkerArray). Here the same three channels become artifacts:

  * `export_landmarks_ply`  — the live landmark cloud as a PLY point cloud
    (drop into any viewer: meshlab, CloudCompare, rerun),
  * `plot_trajectory`       — bird's-eye (x, z) trajectory figure with
    active-keyframe and landmark overlays (matplotlib, PNG),
  * `TrajectoryRecorder`    — streaming per-frame pose/keyframe channel in
    JSONL for external tooling.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


def export_landmarks_ply(map_store, path: str):
    """Write the live landmark cloud (arena rows with alive=True) to PLY."""
    rows = np.nonzero(map_store.alive)[0]
    pts = map_store.pos[rows]
    inlier = map_store.inlier[rows]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, ok in zip(pts, inlier):
            r, g, b = (80, 200, 80) if ok else (200, 80, 80)
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")


def plot_trajectory(
    estimates: Dict[int, np.ndarray],
    path: str,
    gt_T_c_w: Optional[np.ndarray] = None,
    map_store=None,
):
    """Bird's-eye (x, z) plot of the estimated trajectory, optional ground
    truth, active keyframes, and landmark cloud."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fids = sorted(estimates.keys())
    centers = np.stack(
        [np.linalg.inv(estimates[f])[:3, 3] for f in fids]
    )
    fig, ax = plt.subplots(figsize=(8, 8))
    if map_store is not None:
        rows = np.nonzero(map_store.alive)[0]
        if len(rows):
            pts = map_store.pos[rows]
            ax.scatter(pts[:, 0], pts[:, 2], s=1, c="#cccccc", label="landmarks")
    if gt_T_c_w is not None:
        gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_T_c_w])
        ax.plot(gt_c[:, 0], gt_c[:, 2], "k--", lw=1, label="ground truth")
    ax.plot(centers[:, 0], centers[:, 2], "b-", lw=1.5, label="estimate")
    if map_store is not None:
        kfc = np.stack(
            [np.linalg.inv(kf.T_c_w)[:3, 3] for kf in map_store.keyframes.values()]
        ) if map_store.keyframes else np.zeros((0, 3))
        if len(kfc):
            ax.scatter(kfc[:, 0], kfc[:, 2], c="g", s=25, marker="s",
                       label="active keyframes", zorder=5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend(loc="best")
    ax.set_title("stereo_visual_slam trajectory")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


class LiveViz:
    """Periodic IN-RUN emitter of the reference's three rviz channels
    (visualization.cpp:19-177): while the run is still going it appends the
    current camera pose + the active keyframe window to `live.jsonl` (the
    tf + keyframe-MarkerArray analog) and snapshots the landmark cloud to
    `cloud_<frame>.ply` (the `vslam/feature_map` PointCloud2 analog). Each
    tick costs one map fetch (~0.4 MB), so `every` trades freshness against
    host<->device traffic — the reference publishes keyframes at ~4 Hz
    lifetime (visualization.cpp:174) for the same reason.
    """

    def __init__(self, out_dir: str, every: int = 50, plot: bool = False):
        import os

        self.dir = out_dir
        self.every = max(1, every)
        self.plot = plot
        self.last = -(10 ** 9)
        self.ticks = 0
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl = os.path.join(out_dir, "live.jsonl")
        open(self.jsonl, "w").close()

    def tick(self, slam, frame_id: int, force: bool = False):
        """Call after new frame records arrive; emits when `every` frames
        have passed since the last emission (or `force`)."""
        import os

        if not force and frame_id - self.last < self.every:
            return
        self.last = frame_id
        self.ticks += 1
        m = slam.map            # one device fetch of the live MapState
        T_c_w = slam.estimates.get(frame_id)
        entry = {
            "frame_id": int(frame_id),
            "keyframes": {
                str(fid): [round(float(v), 4)
                           for v in np.linalg.inv(kf.T_c_w)[:3, 3]]
                for fid, kf in m.keyframes.items()
            },
            "n_landmarks": int(m.alive.sum()),
        }
        if T_c_w is not None:
            entry["position"] = [
                round(float(v), 4) for v in np.linalg.inv(T_c_w)[:3, 3]
            ]
        with open(self.jsonl, "a") as f:
            f.write(json.dumps(entry) + "\n")
        export_landmarks_ply(
            m, os.path.join(self.dir, f"cloud_{frame_id:06d}.ply")
        )
        if self.plot:
            plot_trajectory(
                slam.estimates,
                os.path.join(self.dir, f"traj_{frame_id:06d}.png"),
                map_store=m,
            )


class TrajectoryRecorder:
    """Streaming JSONL channel of per-frame poses + keyframe events (the
    tf/marker topics analog)."""

    def __init__(self, path: str):
        self.path = path
        open(path, "w").close()

    def record(self, rec: dict, T_c_w: Optional[np.ndarray] = None):
        out = dict(rec)
        out.pop("wall_s", None)
        if T_c_w is not None:
            T_w_c = np.linalg.inv(T_c_w)
            out["position"] = [round(float(v), 4) for v in T_w_c[:3, 3]]
        with open(self.path, "a") as f:
            f.write(json.dumps(out) + "\n")
