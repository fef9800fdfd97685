"""Run the full SLAM pipeline on a synthetic sequence and report errors.

Usage: python examples/run_synthetic.py [n_frames] [--no-ba] [--cpu]

Runs on JAX's default backend (the GPU where there is one); --cpu forces
the CPU.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.vo import VisualOdometry
from stereo_visual_slam.utils.config import Config


def main():
    n_frames = 60
    for a in sys.argv[1:]:
        if a.isdigit():
            n_frames = int(a)
    enable_ba = "--no-ba" not in sys.argv

    cfg = Config()
    print(f"building world ({n_frames} frames)...")
    world = synthetic.make_world(cfg, n_frames=n_frames, n_points=8000, seed=0)
    vo = VisualOdometry(cfg, pose_path="synthetic_traj.txt", enable_ba=enable_ba)

    t_start = time.perf_counter()
    for f, left, right in synthetic.frames(world):
        rec = vo.process(f, left, right)
        if f < 3 or f % 10 == 0 or rec.get("keyframe"):
            print(
                f"frame {f:4d} {rec['state']:9s} "
                f"kf={int(bool(rec.get('keyframe', False)))} "
                f"inl={rec.get('n_inliers', 0):4d} "
                f"match={rec.get('n_matches', 0):4d} "
                f"new={rec.get('n_new_landmarks', 0):4d} "
                f"{rec['wall_s']*1e3:7.1f} ms"
            )
        if rec["state"] == "lost":
            print("LOST — aborting")
            break
    vo.finish()
    wall = time.perf_counter() - t_start

    # evaluation over tracked frames
    fids = sorted(vo.estimates.keys())
    est = np.stack([vo.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    ate = traj_mod.ate_rmse(est, gt)
    t_err, r_err = traj_mod.kitti_errors(est, gt)
    n_kf = vo.next_kf_id
    print(f"\ntracked {len(fids)}/{n_frames} frames, {n_kf} keyframes in {wall:.1f}s")
    print(f"ATE RMSE: {ate:.3f} m")
    print(f"KITTI-style: trans {t_err:.2f} %  rot {r_err:.4f} deg/m")
    kf_recs = [r for r in vo.stats if r.get("keyframe")]
    tr_recs = [r for r in vo.stats if r["state"] == "tracked" and not r.get("keyframe")]
    if kf_recs:
        print(f"mean keyframe time: {np.mean([r['wall_s'] for r in kf_recs])*1e3:.1f} ms")
    if tr_recs:
        print(f"mean tracking time: {np.mean([r['wall_s'] for r in tr_recs])*1e3:.1f} ms")


if __name__ == "__main__":
    main()
