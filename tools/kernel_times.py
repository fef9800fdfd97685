"""GPU timings that decide which hand-written kernels the frontend keeps.

    python tools/kernel_times.py [--pairs 10] [--only resize]

Needs a GPU (exits otherwise). Host clock around `block_until_ready`,
median of repeated calls after a warm-up call; prints the card's name and
power limit first. Measures, at production shapes (default `Config()`):

  * FAST score + 3x3 NMS at each of the 8 pyramid levels, stacked over the
    8 frames of a chunk as the batch extractor runs it: the XLA formulation
    against the Triton kernel (and several block shapes at level 0);
  * the whole batch extractor of a chunk (the chunk program's front end,
    depth off) with the Triton FAST kernel and with XLA FAST;
  * the stereo ZNCC sweep (`zncc_sweep_xla`) and `match_disparity` at
    N=2048, D=96, p=11 on one 384x1280 frame (the keyframe-only stage);
  * the BRIEF patch gather at the 8-level keypoint budgets over 8 frames:
    the one-hot bf16 matmul gather against the dynamic-slice gather;
  * where the extractor's level scores differ between GPU and CPU: the
    resize weights as each device computes them, and each pyramid level's
    resize on both against float64 host products of either device's
    weights, at the production precision (HIGHEST), at DEFAULT, under
    `jax.default_matmul_precision("highest")` and with the explicit
    F32_F32_F32 dot algorithm, and the resize's time at HIGHEST and at
    F32_F32_F32;
  * end to end: staged chunk frames/s with the Triton FAST kernel and with
    XLA FAST, in `--pairs` alternating pairs (A B, B A, ...) over the
    216-frame default and the 300-frame hard profile.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timed(fn, *args, reps=30):
    """Median seconds per call of a jitted fn (after one warm-up call)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def onehot_gather(img, yx, patch):
    """The earlier one-hot bf16 matmul patch gather, kept here to time it."""
    import jax
    import jax.numpy as jnp

    P = patch
    r = P // 2
    H, W = img.shape
    N = yx.shape[0]
    y0 = jnp.clip(yx[:, 0] - r, 0, H - P)
    x0 = jnp.clip(yx[:, 1] - r, 0, W - P)
    ridx = (y0[:, None] + jnp.arange(P)[None, :]).reshape(-1)
    row_onehot = (jnp.arange(H)[None, :] == ridx[:, None]).astype(jnp.bfloat16)
    rows = jnp.dot(row_onehot, img.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32).reshape(N, P, W)
    cols = x0[:, None] + jnp.arange(P)[None, :]
    col_onehot = (jnp.arange(W)[None, :, None] == cols[:, None, :]).astype(
        jnp.bfloat16)
    return jax.lax.dot_general(
        rows.astype(jnp.bfloat16), col_onehot,
        (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32)


def level_images(left, cfg, level, precision):
    """(B * H_i, W_i) stacked level image, resized and padded as the batch
    extractor does, with the resize contraction at `precision`."""
    import jax

    from stereo_visual_slam.ops import image as im_ops

    vh, vw = cfg.image_hw
    _, (h_i, w_i), (H_i, W_i), _ = level
    imgs = jax.vmap(lambda im: im_ops.pad_to(
        jax.image.resize(im[:vh, :vw], (h_i, w_i), method="linear",
                         precision=precision), (H_i, W_i)))(left)
    return imgs.reshape(-1, W_i)


def fast_variants():
    from stereo_visual_slam.models import frontend
    from stereo_visual_slam.ops import fast as fast_ops

    return {
        "triton": frontend._fast_nms,
        "xla": lambda im, th: fast_ops.nms_3x3(fast_ops.fast_score_map(im, th)),
    }


def time_fast_levels(cfg, left):
    import jax

    from stereo_visual_slam.models import frontend
    from stereo_visual_slam.ops import fast as fast_ops
    from stereo_visual_slam.ops.pallas import fast_kernel

    thr = cfg.frontend.fast_threshold
    B, H, W = left.shape
    xla = jax.jit(lambda im: fast_ops.nms_3x3(fast_ops.fast_score_map(im, thr)))
    tri = jax.jit(lambda im: fast_ops.nms_3x3(fast_kernel.fast_score_map(im, thr)))
    stacked = left.reshape(B * H, W)
    for block, nw in (((16, 64), 4), ((8, 128), 4), ((16, 128), 8),
                      ((32, 64), 8), ((8, 64), 2)):
        k = jax.jit(lambda im, block=block, nw=nw: fast_ops.nms_3x3(
            fast_kernel.fast_score_map(im, thr, block=block, num_warps=nw)))
        t = timed(k, stacked)
        print(f"FAST+NMS level 0 Triton block={block} warps={nw}: "
              f"{t * 1e3:.4f} ms", flush=True)
    hi = jax.lax.Precision.HIGHEST
    total = {"xla": 0.0, "triton": 0.0}
    for i, level in enumerate(frontend._level_geometry(cfg)):
        img = stacked if i == 0 else jax.jit(
            lambda im, level=level: level_images(im, cfg, level, hi))(left)
        tx, tt = timed(xla, img), timed(tri, img)
        total["xla"] += tx
        total["triton"] += tt
        same = bool(jax.numpy.array_equal(xla(img), tri(img)))
        print(f"FAST+NMS level {i} ({img.shape[0]}x{img.shape[1]}): XLA "
              f"{tx * 1e3:.4f} ms, Triton {tt * 1e3:.4f} ms (equal: {same})",
              flush=True)
    print(f"FAST+NMS all 8 levels, sum of separate calls: XLA "
          f"{total['xla'] * 1e3:.4f} ms, Triton {total['triton'] * 1e3:.4f} "
          "ms", flush=True)


def time_extractor(cfg, images):
    from stereo_visual_slam.models import frontend

    variants = fast_variants()
    for name in ("triton", "xla"):
        frontend._fast_nms = variants[name]
        ext = frontend.make_batch_extractor(cfg, with_depth=False)
        t = timed(ext, images)
        print(f"batch extractor ({images.shape[0]} frames, depth off) "
              f"FAST={name}: {t * 1e3:.4f} ms", flush=True)
    frontend._fast_nms = variants["triton"]


def time_stereo_and_gather(cfg, images, left, right):
    import jax
    import jax.numpy as jnp

    from stereo_visual_slam.models import frontend
    from stereo_visual_slam.ops import image as im_ops
    from stereo_visual_slam.ops import stereo as stereo_ops

    fe = cfg.frontend
    B = left.shape[0]
    N = fe.max_raw_keypoints
    feats = frontend.make_batch_extractor(cfg, with_depth=False)(images)
    yx = jnp.round(feats.yx[0]).astype(jnp.int32)
    sweep = jax.jit(functools.partial(
        stereo_ops.zncc_sweep_xla, patch=fe.stereo_patch,
        max_disparity=fe.max_disparity))
    t = timed(sweep, left[0], right[0], yx)
    print(f"zncc_sweep_xla N={N} D={fe.max_disparity} p={fe.stereo_patch}: "
          f"{t * 1e3:.4f} ms", flush=True)
    md = jax.jit(functools.partial(
        stereo_ops.match_disparity, fx=cfg.camera.fx,
        baseline=cfg.camera.baseline, max_disparity=fe.max_disparity,
        patch=fe.stereo_patch))
    t = timed(md, left[0], right[0], yx, feats.valid[0])
    print(f"match_disparity N={N}: {t * 1e3:.4f} ms", flush=True)

    rng = np.random.default_rng(0)
    imgs, coords = [], []
    for _, (hi, wi), (Hi, Wi), budget in frontend._level_geometry(cfg):
        imgs.append(jnp.asarray(rng.uniform(0, 255, (B, Hi, Wi)), jnp.float32))
        coords.append(jnp.asarray(np.stack(
            [rng.integers(0, hi, (B, budget)), rng.integers(0, wi, (B, budget))],
            -1), jnp.int32))
    P = fe.patch_size

    def all_levels(gather):
        return jax.jit(lambda ims, yxs: [
            jax.vmap(lambda im, c: gather(im, c, P))(im, c)
            for im, c in zip(ims, yxs)])

    for name, g in (("one-hot bf16 matmul", onehot_gather),
                    ("dynamic_slice", im_ops.gather_patches)):
        t = timed(all_levels(g), imgs, coords)
        print(f"patch gather {name}, 8 levels x {B} frames, N={N}/frame: "
              f"{t * 1e3:.4f} ms", flush=True)


def resize_diagnosis(cfg, images_np):
    """Where GPU and CPU level scores part: the resize weights each device
    computes, and the resize per level against float64 products of those
    weights; then the extractor's scores
    at the default context and under a global HIGHEST matmul precision."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from stereo_visual_slam.models import frontend
    from stereo_visual_slam.ops import fast as fast_ops

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    vh, vw = cfg.image_hw
    left_np = images_np[:, 0].astype(np.float32)
    thr = cfg.frontend.fast_threshold
    P = jax.lax.Precision
    F32 = jax.lax.DotAlgorithmPreset.F32_F32_F32
    score = jax.jit(lambda im: fast_ops.fast_score_map(im, thr))
    for i, level in enumerate(frontend._level_geometry(cfg)):
        if i == 0:
            continue
        _, (h_i, w_i), (H_i, W_i), _ = level
        weights = {}
        for dev in (cpu, gpu):
            # resizing an identity along one axis yields that axis' weights,
            # as the device computes them (a product with 1s and 0s is exact)
            with jax.default_device(dev):
                weights[dev.platform] = [np.asarray(jax.image.resize(
                    jnp.eye(n, dtype=jnp.float32), (m, n), "linear"),
                    np.float64) for m, n in ((h_i, vh), (w_i, vw))]
        x64 = left_np[:, :vh, :vw].astype(np.float64)
        wh, ww = weights["cpu"]
        truth = wh @ x64 @ ww.T
        wh_g, ww_g = weights[gpu.platform]
        print(f"  level {i} weights gpu - cpu: max |dW_rows| "
              f"{np.abs(wh_g - wh).max():.3e}, max |dW_cols| "
              f"{np.abs(ww_g - ww).max():.3e}", flush=True)
        truth_g = wh_g @ x64 @ ww_g.T
        out = {}
        for name, dev, prec, ctx in (
                ("gpu HIGHEST", gpu, P.HIGHEST, contextlib.nullcontext()),
                ("gpu DEFAULT", gpu, P.DEFAULT, contextlib.nullcontext()),
                ("gpu HIGHEST, global highest", gpu, P.HIGHEST,
                 jax.default_matmul_precision("highest")),
                ("gpu F32_F32_F32", gpu, F32, contextlib.nullcontext()),
                ("cpu HIGHEST", cpu, P.HIGHEST, contextlib.nullcontext())):
            with ctx:
                f = jax.jit(lambda im, prec=prec: level_images(
                    im, cfg, level, prec))
                try:
                    img = np.asarray(f(jax.device_put(left_np, dev)))
                except Exception as e:  # a backend may refuse an algorithm
                    print(f"  level {i} resize {name}: refused: "
                          f"{str(e).splitlines()[0][:200]}", flush=True)
                    continue
            if i == 1 and name == "gpu HIGHEST":
                hlo = f.lower(jax.device_put(left_np, dev)).compile().as_text()
                for line in hlo.splitlines():
                    if any(t in line for t in ("dot(", "custom-call(",
                                               "algorithm")):
                        print(f"    compiled: {line.strip()[:240]}",
                              flush=True)
            out[name] = img
            img = img.reshape(-1, H_i, W_i)[:, :h_i, :w_i]
            print(f"  level {i} resize {name}: max |x - f64| "
                  f"{np.abs(img - truth).max():.3e}, with the GPU's weights "
                  f"{np.abs(img - truth_g).max():.3e}", flush=True)
        g, c = out["gpu HIGHEST"], out["cpu HIGHEST"]
        sg = np.asarray(score(jax.device_put(g, gpu)))
        sc = np.asarray(score(jax.device_put(c, cpu)))
        sgc = np.asarray(score(jax.device_put(c, gpu)))
        both = (sg > 0) & (sc > 0)
        print(f"  level {i}: max |pixel gpu - cpu| {np.abs(g - c).max():.3e}; "
              f"FAST of the CPU image on GPU == on CPU: "
              f"{np.array_equal(sgc, sc)}; max |score gpu - cpu| "
              f"{np.abs(sg - sc)[both].max() if both.any() else 0:.3e}",
              flush=True)

    for name, prec in (("HIGHEST", P.HIGHEST), ("F32_F32_F32", F32)):
        f = jax.jit(lambda im, prec=prec: [
            level_images(im, cfg, lv, prec)
            for lv in frontend._level_geometry(cfg)[1:]])
        try:
            t = timed(f, jax.device_put(left_np, gpu))
        except Exception as e:
            print(f"  resize of levels 1-7 at {name}: refused: "
                  f"{str(e).splitlines()[0][:200]}", flush=True)
            continue
        print(f"  resize of levels 1-7 ({left_np.shape[0]} frames) at {name}: "
              f"{t * 1e3:.4f} ms", flush=True)

    ext = frontend.make_batch_extractor(cfg, with_depth=False)
    for name, ctx in (("default", contextlib.nullcontext()),
                      ("global highest", jax.default_matmul_precision("highest"))):
        with ctx:
            fg = jax.device_get(ext(jax.device_put(images_np, gpu)))
            fc = jax.device_get(ext(jax.device_put(images_np, cpu)))
        d = chip_smoke.compare_keypoints(fg, fc)
        print(f"  extractor GPU vs CPU ({name} matmul precision): keypoints "
              f"on both {d['share']:.6f}, max |score diff| {d['abs']:.3e}, "
              f"max relative {d['rel']:.3e}", flush=True)


def time_end_to_end(cfg, pairs):
    """Staged frames/s with each FAST variant, in alternating pairs."""
    from stereo_visual_slam.data import synthetic
    from stereo_visual_slam.models import frontend, slam_core
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam

    B = 8
    variants = fast_variants()
    # the jitted chunk program traces on first call, so each variant's FAST
    # function is installed while its program is built and first run
    programs = {}
    for name in ("triton", "xla"):
        frontend._fast_nms = variants[name]
        slam_core.make_chunk_step_packed.cache_clear()
        slam_core._cached_chunk_step.cache_clear()
        programs[name] = slam_core.make_chunk_step_packed(cfg, mesh=None,
                                                          chunk=B)
        slam = ChunkedSlam(cfg, chunk=B)
        slam._packed_step = programs[name]
        t0 = time.perf_counter()
        slam.warmup()
        slam.close()
        print(f"end to end: FAST={name} program warmup "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    frontend._fast_nms = variants["triton"]

    for profile, n_frames, seed in (("default", 216, 0), ("hard", 300, 1)):
        world = synthetic.make_world(cfg, n_frames=n_frames, n_points=8000,
                                     seed=seed, profile=profile)
        frames = list(synthetic.frames(world))
        stager = ChunkedSlam(cfg, chunk=B)
        bufs = stager.stage(frames)
        stager.close()
        fps = {"triton": [], "xla": []}
        ratios = []
        for p in range(pairs):
            order = ("triton", "xla") if p % 2 == 0 else ("xla", "triton")
            for name in order:
                slam = ChunkedSlam(cfg, chunk=B)
                slam._packed_step = programs[name]
                slam.warmup()
                t0 = time.perf_counter()
                slam.run_staged(bufs)
                slam.finish()
                fps[name].append(n_frames / (time.perf_counter() - t0))
            ratios.append(fps["triton"][-1] / fps["xla"][-1])
            print(f"end to end {profile} pair {p} ({order[0]} first): "
                  f"triton {fps['triton'][-1]:.3f}, xla {fps['xla'][-1]:.3f} "
                  f"frames/s, ratio {ratios[-1]:.4f}", flush=True)
        for name, v in fps.items():
            print(f"end to end {profile} FAST={name} over {pairs} runs: "
                  f"median {np.median(v):.3f}, min {min(v):.3f}, "
                  f"max {max(v):.3f} frames/s", flush=True)
        print(f"end to end {profile} triton/xla ratio over {pairs} pairs: "
              f"median {np.median(ratios):.4f}, min {min(ratios):.4f}, "
              f"max {max(ratios):.4f}, pairs > 1: "
              f"{sum(r > 1 for r in ratios)}/{pairs}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10,
                    help="alternating end-to-end pairs per profile")
    ap.add_argument("--only", choices=("all", "resize"), default="all",
                    help="run every measurement, or only the resize one")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("kernel_times: needs a GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    import chip_smoke
    from stereo_visual_slam.data import synthetic
    from stereo_visual_slam.utils.cache import enable_compilation_cache
    from stereo_visual_slam.utils.config import Config

    enable_compilation_cache()
    cfg = Config()
    # the first chunk of the default profile, as chip_smoke.py phase 3
    world = synthetic.make_world(cfg, n_frames=216, n_points=8000, seed=0)
    images_np = chip_smoke.stack_frames(
        cfg, list(itertools.islice(synthetic.frames(world), 8)))
    images = jnp.asarray(images_np)
    left = jnp.asarray(images_np[:, 0].astype(np.float32))
    right = jnp.asarray(images_np[:, 1].astype(np.float32))

    if args.only == "all":
        time_fast_levels(cfg, left)
        time_extractor(cfg, images)
        time_stereo_and_gather(cfg, images, left, right)
    print("resize and extractor scores, GPU against CPU:", flush=True)
    resize_diagnosis(cfg, images_np)
    if args.only == "all":
        time_end_to_end(cfg, args.pairs)


if __name__ == "__main__":
    main()
