"""Long-horizon soak: a reference-scale synthetic run (default 4200 frames,
matching the 4541-frame KITTI seq-00 loop of run_vslam.cpp:40) through the
production chunked pipeline on the default JAX device.

Asserts the properties thousands of evictions / km of trajectory could
break and that no short run can observe:
  * tracking never enters Lost; rejected frames stay rare,
  * the landmark arena never exhausts (allocation failures = 0 spawns on a
    keyframe with free rows needed),
  * host-side memory growth stays bounded (estimates/stats are O(frames)
    records, not leaks of device buffers),
  * KITTI translational error over the whole run stays within the
    reference's 4.17 % gate, and is STABLE: the last third's sub-trajectory
    error is no worse than 2x the first third's.

Usage: python tools/soak.py [n_frames] [chunk]
Writes one summary line to stdout (and exits nonzero on violation).
"""

import resource
import sys
import time

import numpy as np

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.cache import enable_compilation_cache
from stereo_visual_slam.utils.config import Config

RSS_BOUND_MB = 1024


def rss_mb():
    """CURRENT resident set (not the ru_maxrss peak, which the 125k-sprite
    world build pushes far above the pipeline's own footprint)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 4200
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    enable_compilation_cache()
    cfg = Config()

    # keep structure density constant with path length (the default world
    # spreads n_points over speed*n_frames + 80 m of corridor)
    n_points = int(8000 * (n_frames + 80) / (216 + 80))
    t0 = time.perf_counter()
    world = synthetic.make_world(
        cfg, n_frames=n_frames, n_points=n_points, seed=7
    )
    print(f"# world: {n_frames} frames, {n_points} sprites, "
          f"built in {time.perf_counter()-t0:.0f}s", flush=True)

    slam = ChunkedSlam(cfg, chunk=chunk)
    slam.warmup()

    rss0 = rss_mb()
    t0 = time.perf_counter()
    last_report = t0
    live_high_water = 0
    chunk_walls = []  # (frame, wall time) marks for flat-pace check
    for f in range(n_frames):
        left, right = synthetic.render_frame(world, f)
        slam.process(f, left, right)
        if slam.lost:
            break
        now = time.perf_counter()
        if f % 512 == 511:
            chunk_walls.append((f, now - t0))
        if now - last_report > 60:
            live_now = int(slam.map.alive.sum())
            live_high_water = max(live_high_water, live_now)
            print(f"# frame {f}: {f/(now-t0):.1f} fps wall, "
                  f"arena {live_now} live, rss +{rss_mb()-rss0:.0f} MB",
                  flush=True)
            last_report = now
    slam.finish()
    wall = time.perf_counter() - t0

    n_tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    n_rej = sum(1 for s in slam.stats if s["state"] == "rejected")
    n_kf = sum(1 for s in slam.stats if s["keyframe"])
    rss_growth = rss_mb() - rss0

    fids = sorted(slam.estimates)
    est = np.stack([slam.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    t_all, r_all = traj_mod.kitti_errors(est, gt)
    third = len(fids) // 3
    t_first, _ = traj_mod.kitti_errors(est[:third], gt[:third])
    t_last, _ = traj_mod.kitti_errors(est[-third:], gt[-third:])

    # arena health: live rows bounded below capacity at the end
    m = slam.map
    live = int(m.alive.sum())
    live_high_water = max(live_high_water, live)
    L = cfg.ba.max_landmarks

    ok = True

    def check(cond, msg):
        nonlocal ok
        status = "ok" if cond else "FAIL"
        print(f"# soak {status}: {msg}", flush=True)
        ok = ok and cond

    check(not slam.lost, f"never Lost (tracked {n_tracked}/{n_frames}, "
          f"{n_rej} rejected)")
    check(n_rej <= n_frames * 0.02, f"rejections rare ({n_rej})")
    check(live < L, f"arena not exhausted ({live}/{L} live rows)")
    # host records are O(frames) and small; a leak of chunk buffers
    # (8 MB each) would pass this bound within ~100 chunks
    check(rss_growth < RSS_BOUND_MB,
          f"host memory bounded (RSS +{rss_growth:.0f} MB < "
          f"{RSS_BOUND_MB} MB)")
    # binding gate at ~1.5x the error of an earlier 4,541-frame soak
    # (1.67 %); reference parity (4.17 %) checked apart
    check(t_all <= 2.5, f"KITTI trans {t_all:.2f}% <= 2.5% (binding gate)")
    check(t_all <= 4.17, f"KITTI trans {t_all:.2f}% <= 4.17% (ref parity)")
    check(t_last <= max(2.0 * t_first, 1.0),
          f"drift stable (first third {t_first:.2f}%, last {t_last:.2f}%)")

    # flat-pace check: wall fps of the last quarter vs the first quarter
    pace = None
    if len(chunk_walls) >= 8:
        q = len(chunk_walls) // 4
        (f0, t0a), (f1, t1a) = chunk_walls[0], chunk_walls[q]
        (f2, t2a), (f3, t3a) = chunk_walls[-q - 1], chunk_walls[-1]
        fps_first = (f1 - f0) / max(t1a - t0a, 1e-9)
        fps_last = (f3 - f2) / max(t3a - t2a, 1e-9)
        pace = dict(fps_first=round(fps_first, 1), fps_last=round(fps_last, 1))
        check(fps_last >= 0.7 * fps_first,
              f"per-chunk pace flat ({fps_first:.1f} -> {fps_last:.1f} fps)")

    print(
        f"SOAK {'PASS' if ok else 'FAIL'}: {n_frames} frames in {wall:.0f}s "
        f"({n_frames/wall:.1f} fps incl. host render), {n_kf} keyframes, "
        f"trans={t_all:.2f}% rot={r_all:.4f}deg/m ate="
        f"{traj_mod.ate_rmse(est, gt):.2f}m rss+{rss_growth:.0f}MB "
        f"arena_hw={live_high_water} evictions={len(slam._evictions)}",
        flush=True,
    )

    import json
    import os

    artifact = os.environ.get("SOAK_JSON", "")
    if artifact:
        with open(artifact, "w") as fh:
            json.dump(dict(
                n_frames=n_frames,
                n_tracked=n_tracked,
                n_rejected=n_rej,
                n_keyframes=n_kf,
                n_evictions=len(slam._evictions),
                arena_high_water=live_high_water,
                arena_capacity=L,
                lost=bool(slam.lost),
                trans_pct=round(float(t_all), 3),
                rot_deg_per_m=round(float(r_all), 5),
                ate_m=round(float(traj_mod.ate_rmse(est, gt)), 3),
                wall_s=round(wall, 1),
                fps_wall=round(n_frames / wall, 2),
                pace=pace,
                rss_growth_mb=round(rss_growth, 0),
                ok=bool(ok),
            ), fh, indent=1)
        print(f"# artifact written to {artifact}", flush=True)

    if os.environ.get("SOAK_DUMP"):
        with open(os.environ["SOAK_DUMP"], "w") as fh:
            fh.write("frame,state,kf,n_matches,n_inliers,n_new,twist,err_t\n")
            gt_inv = {f: np.linalg.inv(world.poses_T_c_w[f]) for f in fids}
            for s in slam.stats:
                f = s["frame_id"]
                err = ""
                if f in slam.estimates:
                    d = np.linalg.inv(slam.estimates[f])[:3, 3] - gt_inv.get(
                        f, np.eye(4))[:3, 3]
                    err = f"{np.linalg.norm(d):.2f}"
                fh.write(
                    f"{f},{s['state']},{int(s['keyframe'])},"
                    f"{s['n_matches']},{s['n_inliers']},"
                    f"{s['n_new_landmarks']},{s['twist']:.3f},{err}\n"
                )
        print(f"# stats dumped to {os.environ['SOAK_DUMP']}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
