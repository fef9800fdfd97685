"""CLI driver — the analog of the reference's run_vslam node
(src/run_vslam.cpp:17-92): loops a stereo sequence through the pipeline,
schedules BA per keyframe, writes the trajectory, and reports errors.

The default driver is the device-resident chunked SLAM core
(pipeline/chunked.py — the production fast path: map, state machine and BA
schedule all live in the scan carry). `--driver host` selects the
host-orchestrated loop (pipeline/vo.py), kept as the reference-sequenced
test oracle.

Usage:
    python -m stereo_visual_slam.run_vslam --dataset /path/to/seq00 \
        [--sequence 00] [--frames N] [--pose-out estimated_traj.txt]
    python -m stereo_visual_slam.run_vslam --synthetic 100 [--cpu]

    --driver chunked|host   execution path (default: chunked)
    --chunk N               frames per device dispatch (chunked driver)
    --hard                  harder synthetic profile (noise, occluders,
                            low-texture stretch, sharp turns)
    --params params.yaml    YAML overrides (see utils/config_io.py)
    --no-ba                 frontend-only ("Without Optimization" row)
    --lookahead N           pipeline depth (host driver only)
    --mesh-devices N        landmark-shard the BA schedule over N devices
    --distributed           jax.distributed.initialize() from env (multi-host)
    --plot out.png          bird's-eye trajectory figure
    --ply out.ply           landmark cloud export
    --record out.jsonl      per-frame structured log
    --snapshot out.npz      save full SLAM state at the end
    --resume in.npz         restore state before processing
"""

from __future__ import annotations

import argparse
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", help="KITTI sequence dir (or dataset root)")
    p.add_argument("--sequence", help="sequence id when --dataset is a root")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="run on an N-frame synthetic sequence instead")
    p.add_argument("--hard", action="store_true",
                   help="harder synthetic profile (with --synthetic)")
    p.add_argument("--frames", type=int, default=0, help="limit frame count")
    p.add_argument("--params", help="YAML config overrides")
    p.add_argument("--pose-out", default="estimated_traj.txt")
    p.add_argument("--no-ba", action="store_true")
    p.add_argument("--driver", choices=("chunked", "host"), default="chunked")
    p.add_argument("--rolling", type=int, default=0, metavar="K",
                   help="bounded stage-ahead dataset mode: at most K chunk "
                        "buffers in device memory (ChunkedSlam.run_rolling)")
    p.add_argument("--chunk", type=int, default=8,
                   help="chunked driver: frames per dispatch")
    p.add_argument("--lookahead", type=int, default=0,
                   help="host driver: pipeline depth")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard the BA schedule over N devices (0 = off)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize jax.distributed from environment")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--plot", help="write trajectory plot PNG")
    p.add_argument("--ply", help="write landmark cloud PLY")
    p.add_argument("--record", help="write per-frame JSONL log")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="emit live viz (pose+keyframes JSONL, landmark "
                        "cloud PLY) every N frames DURING the run")
    p.add_argument("--viz-dir", default="viz_live",
                   help="directory for --viz-every artifacts")
    p.add_argument("--snapshot", help="save state snapshot at the end")
    p.add_argument("--resume", help="load state snapshot before running")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.distributed:
        from stereo_visual_slam.utils.dist import initialize_distributed

        initialize_distributed()

    import numpy as np

    from stereo_visual_slam.utils.cache import enable_compilation_cache
    from stereo_visual_slam.utils.config import Config

    enable_compilation_cache()

    base = Config()
    if args.params:
        from stereo_visual_slam.utils.config_io import config_from_yaml

        base = config_from_yaml(args.params, base)

    gt = None
    if args.synthetic:
        from stereo_visual_slam.data import synthetic

        cfg = base
        profile = "hard" if args.hard else "default"
        world = synthetic.make_world(
            cfg, n_frames=args.synthetic, n_points=8000, profile=profile
        )
        source = synthetic.frames(world)
        n_frames = args.synthetic
        gt = world.poses_T_c_w
    elif args.dataset:
        from stereo_visual_slam.data import kitti

        seq = kitti.open_sequence(args.dataset, args.sequence)
        cfg = kitti.config_for(seq, base)
        source = seq.frames()
        n_frames = seq.n_frames
        gt = seq.gt_T_c_w
    else:
        print("need --dataset or --synthetic", file=sys.stderr)
        return 2

    if args.frames:
        n_frames = min(n_frames, args.frames)

    mesh = None
    if args.mesh_devices:
        from jax.sharding import Mesh

        devs = jax.devices()[: args.mesh_devices]
        if len(devs) < args.mesh_devices:
            print(
                f"need {args.mesh_devices} devices, have {len(devs)}",
                file=sys.stderr,
            )
            return 2
        mesh = Mesh(np.array(devs), ("lm",))

    recorder = None
    if args.record:
        from stereo_visual_slam.pipeline.viz import TrajectoryRecorder

        recorder = TrajectoryRecorder(args.record)

    args.live_viz = None
    if args.viz_every:
        from stereo_visual_slam.pipeline.viz import LiveViz

        args.live_viz = LiveViz(args.viz_dir, every=args.viz_every)

    if args.driver == "chunked":
        runner = _run_chunked
    else:
        runner = _run_host
    slam, wall, n_done, n_kf = runner(
        args, cfg, source, n_frames, mesh, recorder
    )

    print(f"processed {n_done} frames, {n_kf} keyframes "
          f"in {wall:.1f}s ({n_done / max(wall, 1e-9):.2f} fps)")

    if gt is not None and len(slam.estimates) > 2:
        from stereo_visual_slam.pipeline import trajectory as traj_mod

        fids = sorted(k for k in slam.estimates if k < len(gt))
        est = np.stack([slam.estimates[f] for f in fids])
        t_err, r_err = traj_mod.kitti_errors(est, gt[fids])
        ate = traj_mod.ate_rmse(est, gt[fids])
        print(f"ATE RMSE {ate:.3f} m | KITTI trans {t_err:.2f} % "
              f"rot {r_err:.4f} deg/m")

    if args.plot:
        from stereo_visual_slam.pipeline.viz import plot_trajectory

        plot_trajectory(slam.estimates, args.plot, gt, slam.map)
        print(f"wrote {args.plot}")
    if args.ply:
        from stereo_visual_slam.pipeline.viz import export_landmarks_ply

        export_landmarks_ply(slam.map, args.ply)
        print(f"wrote {args.ply}")
    if args.snapshot:
        if args.driver == "chunked":
            slam.save_snapshot(args.snapshot)
        else:
            from stereo_visual_slam.pipeline.snapshot import save_snapshot

            save_snapshot(slam, args.snapshot)
        print(f"wrote {args.snapshot}")
    return 0


def _run_chunked(args, cfg, source, n_frames, mesh, recorder):
    """Production path: the device-resident chunked core."""
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam

    if args.no_ba:
        import dataclasses

        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, enable_ba=False))
    slam = ChunkedSlam(
        cfg, chunk=args.chunk, pose_path=args.pose_out, mesh=mesh
    )
    if args.resume:
        slam.load_snapshot(args.resume)

    live_viz = getattr(args, "live_viz", None)
    seen = 0  # stats entries already reported
    t0 = time.perf_counter()
    if args.rolling:
        # bounded stage-ahead dataset mode: the lazy source (native
        # prefetcher behind kitti frames) is pulled K chunks ahead
        def bounded():
            for f, left, right in source:
                if f >= n_frames:
                    break
                yield f, left, right

        def progress():
            nonlocal seen
            seen = _report_chunked(slam, seen, recorder, args.quiet)
            if live_viz is not None and slam.stats:
                live_viz.tick(slam, slam.stats[-1]["frame_id"])

        slam.run_rolling(
            bounded(), window_chunks=args.rolling, on_progress=progress
        )
        if slam.lost:
            print("tracking LOST", file=sys.stderr)
    else:
        for f, left, right in source:
            if f >= n_frames:
                break
            slam.process(f, left, right)
            seen = _report_chunked(slam, seen, recorder, args.quiet)
            if live_viz is not None:
                # cadence keyed on FED frames (deterministic), snapshotting
                # the live map/pose state as of what records have arrived
                live_viz.tick(slam, f)
            if slam.lost:
                print("tracking LOST", file=sys.stderr)
                break
    slam.finish()
    _report_chunked(slam, seen, recorder, args.quiet)
    if live_viz is not None and slam.stats:
        live_viz.tick(slam, slam.stats[-1]["frame_id"], force=True)
    wall = time.perf_counter() - t0

    n_done = len(slam.stats)
    n_kf = sum(1 for s in slam.stats if s["keyframe"])
    return slam, wall, n_done, n_kf


def _report_chunked(slam, seen, recorder, quiet):
    """Stream newly collected frame records to stdout / the recorder."""
    for rec in slam.stats[seen:]:
        if recorder:
            recorder.record(rec, slam.estimates.get(rec["frame_id"]))
        if not quiet and (rec["frame_id"] % 50 == 0 or rec["keyframe"]):
            print(
                f"frame {rec['frame_id']:5d} {rec['state']:9s} "
                f"kf={int(rec['keyframe'])} "
                f"inl={rec['n_inliers']:4d}",
                flush=True,
            )
    return len(slam.stats)


def _run_host(args, cfg, source, n_frames, mesh, recorder):
    """Reference-sequenced host loop (test oracle)."""
    from stereo_visual_slam.pipeline.vo import VisualOdometry

    vo = VisualOdometry(
        cfg,
        pose_path=args.pose_out,
        enable_ba=not args.no_ba,
        lookahead=args.lookahead,
    )
    if args.resume:
        from stereo_visual_slam.pipeline.snapshot import load_snapshot

        load_snapshot(vo, args.resume)

    t0 = time.perf_counter()
    for f, left, right in source:
        if f >= n_frames:
            break
        rec = vo.process(f, left, right)
        if recorder:
            recorder.record(rec, vo.estimates.get(rec.get("frame_id", -1)))
        if not args.quiet and (f % 50 == 0 or rec.get("keyframe")):
            print(
                f"frame {f:5d} {rec['state']:9s} "
                f"kf={int(bool(rec.get('keyframe', False)))} "
                f"inl={rec.get('n_inliers', 0):4d}",
                flush=True,
            )
        if rec["state"] == "lost":
            print("tracking LOST", file=sys.stderr)
            break
    vo.finish()
    wall = time.perf_counter() - t0
    return vo, wall, vo.last_frame_id + 1, vo.next_kf_id


if __name__ == "__main__":
    sys.exit(main())
