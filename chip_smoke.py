"""Proof that the SLAM pipeline runs on the GPU, at production shapes.

    python chip_smoke.py              # one GPU: main path, then kernels
    python chip_smoke.py --devices 4  # landmark-sharded BA over 4 GPUs only

One process runs every phase (a JAX process reserves most of a card's
memory, so a second one would not fit). The last line of standard output
is one JSON object, {"ok": true, "device": {...}}; it is printed only when
every phase passed. Any failure exits non-zero.

Phases on one GPU:
  1. device: JAX must see GPUs; prints the card's name and power limit.
  2. main path: `ChunkedSlam` over the default (216 frames), hard (300)
     and highway (200) synthetic profiles at the default `Config()`
     (376x1241 padded to 384x1280, N=2048 keypoints over 8 levels,
     L=4096, Kw=10, B=8). Prints cold and warm compile seconds and the
     chunk program's memory analysis; fails on Lost, on a profile in which
     BA never ran, or on a failed accuracy gate of bench.py.
  3. kernels: the Triton FAST kernel against the XLA formulation on the
     stacked level-0 batch, and the batch extractor and stereo matcher on
     the GPU against the same functions on the host CPU, each within a
     stated tolerance.

With --devices N, only the sharded phase runs: 64 frames of the default
profile with `mesh=Mesh(N GPUs, ("lm",))` against one GPU in the same
process; keyframe, tracked and Lost flags must agree and poses within a
stated tolerance.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHUNK = 8
PROFILES = (("default", 216, 0), ("hard", 300, 1), ("highway", 200, 5))


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    print(f"  [{'PASS' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def require_gpu(n: int = 1):
    """The first n JAX devices, which must be GPUs; exits otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r}); "
            "this check runs only on the card"
        )
    if len(devs) < n:
        raise SystemExit(f"chip_smoke: need {n} GPUs, JAX sees {len(devs)}")
    return devs[:n]


def print_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in out.splitlines():
        print(f"card: {line}", flush=True)


def render(cfg, profile, n_frames, seed):
    from stereo_visual_slam.data import synthetic

    world = synthetic.make_world(
        cfg, n_frames=n_frames, n_points=8000, seed=seed, profile=profile
    )
    return world, list(synthetic.frames(world))


def clear_program_caches():
    """Drop every in-process compiled program, so the next build traces
    and compiles again (from the persistent cache, when it is enabled)."""
    import jax

    from stereo_visual_slam.models import slam_core
    from stereo_visual_slam.pipeline import chunked

    jax.clear_caches()
    slam_core.make_chunk_step_packed.cache_clear()
    slam_core._cached_chunk_step.cache_clear()
    chunked._make_record_packer.cache_clear()


# --------------------------------------------------------------------------
def phase_compile(cfg):
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam

    print("phase 2a: chunk program compile", flush=True)
    t0 = time.perf_counter()
    slam = ChunkedSlam(cfg, chunk=CHUNK)
    slam.warmup()
    cold = time.perf_counter() - t0
    compiled = slam._packed_step.lower(
        slam.carry, slam._upload_job([]), slam.key
    ).compile()
    print(f"  memory_analysis: {compiled.memory_analysis()}", flush=True)
    slam.close()

    clear_program_caches()
    t0 = time.perf_counter()
    slam = ChunkedSlam(cfg, chunk=CHUNK)
    slam.warmup()
    warm = time.perf_counter() - t0
    slam.close()
    print(f"  cold compile (first warmup, trace + compile + 2 runs): "
          f"{cold:.1f} s", flush=True)
    print(f"  warm compile (persistent cache, trace + load + 2 runs): "
          f"{warm:.1f} s", flush=True)


def run_profile(cfg, profile, n_frames, seed):
    from bench import GATES
    from stereo_visual_slam.pipeline import trajectory as traj_mod
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam

    world, frames = render(cfg, profile, n_frames, seed)
    slam = ChunkedSlam(cfg, chunk=CHUNK)
    slam.warmup()
    bufs = slam.stage(frames)
    t0 = time.perf_counter()
    slam.run_staged(bufs)
    slam.finish()
    wall = time.perf_counter() - t0

    stats = slam.stats
    n_tracked = sum(1 for s in stats if s["state"] == "tracked")
    n_kf = sum(1 for s in stats if s["keyframe"])
    ba_chunks = {s["frame_id"] // CHUNK for s in stats
                 if s["ba_cost"] is not None}
    fids = sorted(slam.estimates)
    est = np.stack([slam.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    t_err, r_err = traj_mod.kitti_errors(est, gt)
    ate = traj_mod.ate_rmse(est, gt)
    g = GATES[profile]
    print(f"phase 2: {profile} profile, {n_frames} frames", flush=True)
    print(f"  tracked {n_tracked}/{n_frames}, keyframes {n_kf}, "
          f"BA ran in {len(ba_chunks)}/{-(-n_frames // CHUNK)} chunks, "
          f"lost={slam.lost}", flush=True)
    print(f"  KITTI trans {t_err:.4f} %, rot {r_err:.6f} deg/m, "
          f"ATE {ate:.4f} m", flush=True)
    print(f"  staged run {wall:.3f} s = {n_frames / wall:.2f} frames/s "
          "(warm, BA included)", flush=True)
    check(len(stats) == n_frames, f"{profile}: a record for every frame")
    check(not slam.lost, f"{profile}: never Lost")
    check(len(ba_chunks) > 0, f"{profile}: BA ran")
    check(t_err <= g["trans"] and ate <= g["ate"],
          f"{profile}: gate trans<={g['trans']}% ate<={g['ate']}m")
    return frames, slam


def phase_streaming_and_cli(cfg, frames, staged):
    """The live upload ring and the CLI over the default profile: both must
    reproduce the staged run (the ring reuses host buffers; a device_put
    that aliased one would corrupt a later chunk)."""
    from stereo_visual_slam import run_vslam
    from stereo_visual_slam.pipeline import trajectory as traj_mod
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam

    print(f"phase 2b: streaming uploads and the CLI, {len(frames)} frames",
          flush=True)
    slam = ChunkedSlam(cfg, chunk=CHUNK)
    slam.run(frames, stage=False)
    slam.finish()
    same = (sorted(slam.estimates) == sorted(staged.estimates) and all(
        np.array_equal(slam.estimates[f], staged.estimates[f])
        for f in staged.estimates))
    check(same and slam.stats == staged.stats,
          "streaming run == staged run, bit for bit")

    out_dir = os.path.join(ROOT, ".chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    pose_path = os.path.join(out_dir, "cli_traj.txt")
    rc = run_vslam.main(["--synthetic", str(len(frames)), "--quiet",
                         "--pose-out", pose_path])
    written = traj_mod.read_trajectory(pose_path)
    common = sorted(set(written) & set(staged.estimates))
    worst = max((np.abs(written[f] - np.linalg.inv(staged.estimates[f])).max()
                 for f in common), default=np.inf)
    print(f"  CLI rc {rc}, wrote {len(written)} keyframe poses, "
          f"{len(common)} in the staged run, max |T_w_c - staged| "
          f"{worst:.2e}", flush=True)
    # poses are written as text with 9 significant digits
    check(rc == 0 and len(common) == len(written) > 0 and worst < 1e-4,
          "CLI (run_vslam --synthetic) reproduces the staged run")


# --------------------------------------------------------------------------
def stack_frames(cfg, frames):
    H, W = cfg.padded_hw
    images = np.zeros((len(frames), 2, H, W), np.uint8)
    for i, (_, left, right) in enumerate(frames):
        h, w = left.shape
        images[i, 0, :h, :w] = left
        images[i, 1, :h, :w] = right
    return images


def compare_keypoints(fg, fc):
    """Valid keypoints of two batch-extractor outputs, matched on (frame,
    y, x, scale): the shares found on both and in the same slot, and the
    largest absolute and relative score difference over those found on
    both."""
    def keypoints(f):
        out = {}
        for b in range(f.yx.shape[0]):
            for i in np.flatnonzero(f.valid[b]):
                key = (b, *f.yx[b, i].tolist(), float(f.scale[b, i]))
                out[key] = (f.score[b, i], f.packed[b, i])
        return out

    kg, kc = keypoints(fg), keypoints(fc)
    common = sorted(set(kg) & set(kc))
    n = len(set(kg) | set(kc))
    diff = np.array([abs(kg[k][0] - kc[k][0]) for k in common] or [0.0])
    ref = np.array([abs(kc[k][0]) for k in common] or [1.0])
    return dict(
        gpu=kg, cpu=kc, common=common, n=n,
        share=len(common) / max(n, 1),
        slot=float(np.mean(np.all(fg.yx == fc.yx, axis=-1))),
        abs=float(diff.max()), rel=float((diff / ref).max()),
    )


def phase_kernels(cfg, frames):
    """Each kernel on the card against its plain reference."""
    import jax

    from stereo_visual_slam.models import frontend
    from stereo_visual_slam.ops import fast as fast_ops
    from stereo_visual_slam.ops import stereo as stereo_ops
    from stereo_visual_slam.ops.pallas import fast_kernel

    print(f"phase 3: kernels on the stacked level-0 batch of {CHUNK} frames",
          flush=True)
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    images = stack_frames(cfg, frames[:CHUNK])
    B, _, H, W = images.shape
    thr = float(cfg.frontend.fast_threshold)
    left = jax.device_put(
        images[:, 0].astype(np.float32).reshape(B * H, W), gpu
    )

    # FAST: elementwise f32 subtract/compare/min/max, no matmul -> exact
    kern = jax.jit(lambda im: fast_kernel.fast_score_map(im, thr))(left)
    ref = jax.jit(lambda im: fast_ops.fast_score_map(im, thr))(left)
    host = jax.jit(lambda im: fast_ops.fast_score_map(im, thr))(
        jax.device_put(left, cpu)
    )
    kern, ref, host = (np.asarray(a) for a in (kern, ref, host))
    print(f"  FAST score map ({B * H}x{W}): {int((ref > 0).sum())} corner "
          f"pixels, max |kernel - XLA| {np.abs(kern - ref).max()}", flush=True)
    check(np.array_equal(kern, ref), "Triton FAST kernel == XLA, exact")
    check(np.array_equal(ref, host), "XLA FAST on GPU == on CPU, exact")

    # batch extractor, GPU (Triton FAST) against host CPU (XLA FAST)
    ext = frontend.make_batch_extractor(cfg, with_depth=True)
    fg = jax.device_get(ext(jax.device_put(images, gpu)))
    fc = jax.device_get(ext(jax.device_put(images, cpu)))
    d = compare_keypoints(fg, fc)
    kg, kc, common = d["gpu"], d["cpu"], d["common"]
    print(f"  extractor keypoints found on both GPU and CPU: {d['share']:.6f} "
          f"of {d['n']} (same slot: {d['slot']:.6f}), max score difference "
          f"{d['abs']:.2e}, relative {d['rel']:.2e}", flush=True)
    # levels > 0 come from the pyramid resize, whose weights each device
    # computes from f32 sample positions up to ~1240 px: the H100's differ
    # from the CPU's by up to 5.1e-5, which moves resized 0-255 pixels by up
    # to 8.7e-3 (each device's resize matches a float64 product of its own
    # weights within 3e-5; tools/kernel_times.py). A FAST score is a
    # difference of two pixels, so scores may differ by twice that; a
    # corner whose score sits at the threshold or a top-k cut can move
    check(d["share"] >= 0.999 and d["abs"] <= 2e-2,
          "keypoints on both >= 99.9 %, scores within 2e-2")
    bits_g = np.unpackbits(np.stack([kg[k][1] for k in common]).view(np.uint8))
    bits_c = np.unpackbits(np.stack([kc[k][1] for k in common]).view(np.uint8))
    flip = float((bits_g != bits_c).mean())
    print(f"  descriptor bits flipped: {flip:.2e} over {bits_g.size} bits",
          flush=True)
    # bf16 x bf16 products summed in f32 in another order: a bit flips
    # only where the BRIEF intensity difference is within rounding of 0
    check(flip <= 1e-3, "descriptor bits flipped <= 0.1 %")

    # stereo on identical inputs: the GPU's keypoints, matched on both
    fe, cam = cfg.frontend, cfg.camera
    row_off = (np.arange(B, dtype=np.int32) * H)[:, None]
    yx_int = np.round(fg.yx).astype(np.int32)
    yx_st = np.stack([yx_int[..., 0] + row_off, yx_int[..., 1]], -1)
    yx_st = yx_st.reshape(B * yx_int.shape[1], 2)
    kw = dict(
        fx=cam.fx, baseline=cam.baseline, max_disparity=fe.max_disparity,
        patch=fe.stereo_patch, min_zncc=fe.min_zncc, min_depth=fe.min_depth,
        max_depth=fe.max_depth, reliable_depth=fe.reliable_depth,
    )
    right = images[:, 1].astype(np.float32).reshape(B * H, W)
    out = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        args = [jax.device_put(a, dev) for a in (
            np.asarray(left), right, yx_st, fg.valid.reshape(-1))]
        out[name] = jax.device_get(stereo_ops.match_disparity(*args, **kw))
    sg, sc = out["gpu"], out["cpu"]
    valid_agree = float((sg.valid == sc.valid).mean())
    rel_agree = float((sg.reliable == sc.reliable).mean())
    both = sg.valid & sc.valid
    dd = np.abs(sg.disparity[both] - sc.disparity[both])
    close = float((dd <= 1e-3).mean()) if dd.size else 1.0
    print(f"  stereo ({both.sum()} keypoints valid on both): valid agree "
          f"{valid_agree:.6f}, reliable agree {rel_agree:.6f}, "
          f"|d_gpu - d_cpu| max {dd.max() if dd.size else 0:.2e} px, "
          f"share <= 1e-3 px {close:.6f}", flush=True)
    # the ZNCC einsum runs at "highest" precision on both; only the f32
    # summation order differs, which can flip the argmax of a near tie
    check(valid_agree >= 0.999 and rel_agree >= 0.999,
          "stereo valid/reliable flags agree >= 99.9 %")
    check(close >= 0.999, "disparity within 1e-3 px on >= 99.9 %")


# --------------------------------------------------------------------------
def phase_sharded(cfg, n_dev):
    import jax
    from jax.sharding import Mesh

    from stereo_visual_slam.pipeline.chunked import ChunkedSlam

    devs = jax.devices()[:n_dev]
    print(f"phase 4: landmark-sharded BA over {n_dev} "
          f"{devs[0].device_kind} against one device, 64 frames", flush=True)
    _, frames = render(cfg, "default", 64, 0)
    runs = {}
    for name, mesh in (("sharded", Mesh(np.array(devs), ("lm",))),
                       ("single", None)):
        slam = ChunkedSlam(cfg, chunk=CHUNK, mesh=mesh)
        t0 = time.perf_counter()
        slam.warmup()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        slam.run(frames)
        slam.finish()
        wall = time.perf_counter() - t0
        runs[name] = slam
        n_ba = sum(1 for s in slam.stats if s["ba_cost"] is not None)
        print(f"  {name}: compile {t_compile:.1f} s, run {wall:.3f} s, "
              f"keyframes {sum(s['keyframe'] for s in slam.stats)}, "
              f"BA frames {n_ba}, lost={slam.lost}", flush=True)
    sh, si = runs["sharded"], runs["single"]
    hlo = sh._packed_step.lower(
        sh.carry, sh._upload_job([]), sh.key
    ).compile().as_text()
    n_ar = hlo.count("all-reduce-start(") + hlo.count(" all-reduce(")
    print(f"  sharded program: {n_ar} all-reduce ops", flush=True)
    check(n_ar > 0 and any(s["ba_cost"] is not None for s in sh.stats),
          "BA executed sharded (all-reduce in the program, BA ran)")
    flags = [(s["frame_id"], s["state"], s["keyframe"]) for s in sh.stats]
    check(flags == [(s["frame_id"], s["state"], s["keyframe"])
                    for s in si.stats] and sh.lost == si.lost,
          "keyframe, tracked and Lost flags equal")
    common = sorted(set(sh.estimates) & set(si.estimates))
    dt = max(np.linalg.norm(np.linalg.inv(sh.estimates[f])[:3, 3]
                            - np.linalg.inv(si.estimates[f])[:3, 3])
             for f in common)
    print(f"  max camera-position difference over {len(common)} poses: "
          f"{dt:.3e} m", flush=True)
    # the psum adds per-device Schur partials in another order than one
    # device; LM accept/reject and chi2 inlier flags can flip at their
    # thresholds, so differences grow along the sequence (same bound as
    # tests/test_parallel.py)
    check(dt < 5e-2, "poses agree within 5 cm")


# --------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the sharded phase over this many GPUs")
    args = ap.parse_args(argv)

    devs = require_gpu(args.devices)
    sys.path.insert(0, ROOT)
    import jax

    from stereo_visual_slam.utils.cache import enable_compilation_cache
    from stereo_visual_slam.utils.config import Config

    print_card()
    print(f"jax {jax.__version__}: {len(jax.devices())} x "
          f"{devs[0].device_kind}", flush=True)
    cache_dir = enable_compilation_cache()
    n_cached = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    print(f"compile cache {cache_dir}: {n_cached} entries at start",
          flush=True)
    cfg = Config()
    t0 = time.perf_counter()
    try:
        if args.devices > 1:
            phase_sharded(cfg, args.devices)
        else:
            phase_compile(cfg)
            runs = {p: run_profile(cfg, p, n, seed)
                    for p, n, seed in PROFILES}
            frames, staged = runs["default"]
            phase_streaming_and_cli(cfg, frames, staged)
            phase_kernels(cfg, frames)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
