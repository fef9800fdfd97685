"""Two-length-fori DEVICE-TIME split of the per-frame tracking scan.

Phases, on REAL extracted features from the production extractor:
  1. full feats_step (matcher + PnP + sanity + insert + BA-off map path)
  2. track_step alone (matcher + PnP + gathers)
  3. matcher alone
  4. PnP-RANSAC alone
  5. insert/map bookkeeping = (1) - (2) approx (plus cond/sel overhead)

Every fori body threads the loop carry into the DATA so XLA cannot hoist
the body (the round-3 accounting was invalidated exactly this way).

Usage: python tools/profile_scan_split.py
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.models import frontend as frontend_mod
from stereo_visual_slam.models import slam_core
from stereo_visual_slam.models import vslam
from stereo_visual_slam.ops import matcher as matcher_ops
from stereo_visual_slam.tracking import pnp
from stereo_visual_slam.utils.cache import enable_compilation_cache
from stereo_visual_slam.utils.config import Config

B = 8


def loop_time(body, label, r=8):
    runs = {}
    for n in (r, 3 * r):

        @jax.jit
        def run(s, n=n):
            return jax.lax.fori_loop(0, n, lambda i, c: body(c), s)

        jax.block_until_ready(run(jnp.zeros(())))
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(jnp.ones(()) * 1e-6))
            best = min(best, time.perf_counter() - t0)
        runs[n] = best
    dt = (runs[3 * r] - runs[r]) / (2 * r)
    print(f"{label:40s} {dt*1e3:8.2f} ms/iter", flush=True)
    return dt


def main():
    enable_compilation_cache()
    cfg = Config()
    fe = cfg.frontend
    pc = cfg.pnp
    mc = cfg.matcher
    cam = cfg.camera
    H, W = cfg.padded_hw
    world = synthetic.make_world(cfg, n_frames=B + 1, n_points=8000, seed=0)
    stacked = np.zeros((B, 2, H, W), np.uint8)
    for i, (f, l, r_) in enumerate(synthetic.frames(world)):
        if f >= B:
            break
        h, w = l.shape
        stacked[i, 0, :h, :w] = l
        stacked[i, 1, :h, :w] = r_
    images = jax.device_put(jnp.asarray(stacked))

    batch_extract = frontend_mod.make_batch_extractor(cfg)
    feats = jax.block_until_ready(batch_extract(images))
    f0 = jax.tree.map(lambda a: a[0], feats)
    key = jax.random.PRNGKey(0)
    K = jnp.asarray(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], jnp.float32
    )

    # a carry mid-sequence: run the first chunk through the real step
    feats_step = slam_core.make_feats_step(cfg)
    carry = slam_core.init_carry(cfg)

    def seed_body(c, xs):
        feat, fid = xs
        c2, rec = feats_step(c, feat, fid, jax.random.fold_in(key, fid))
        return c2, rec.twist

    carry, _ = jax.block_until_ready(jax.jit(
        lambda c: jax.lax.scan(seed_body, c,
                               (feats, jnp.arange(B, dtype=jnp.int32)))
    )(carry))
    tstate = carry.tstate

    def feed(*xs):
        return sum(jnp.tanh(jnp.sum(x.astype(jnp.float32))) * 1e-20
                   for x in xs)

    # ---- 1. full feats_step (one frame; carry threaded via s)
    def p_step(s):
        f = f0._replace(yx=f0.yx + s * 1e-9)
        c2, rec = feats_step(carry, f, carry.last_frame_id + 1, key)
        return feed(c2.tstate.T_c_w, rec.twist, c2.mstate.pos)

    loop_time(p_step, "feats_step (one frame, kf branch live)")

    track_step, _ = vslam.make_tracker(cfg)

    # ---- 2. track_step alone
    def p_track(s):
        f = f0._replace(yx=f0.yx + s * 1e-9)
        st, info = track_step(f, tstate, tstate.T_c_w, 1.0 + s * 0, key)
        return feed(st.T_c_w, info.twist_norm)

    loop_time(p_track, "track_step (matcher+PnP+gathers)")

    # ---- 3. matcher alone
    def p_match(s):
        m = matcher_ops.match(
            tstate.signs, tstate.valid, f0.signs + s * 1e-9, f0.valid,
            1.0,
            pred_yx=tstate.yx, curr_yx=f0.yx,
            search_radius=mc.search_radius, base_gate=mc.base_gate,
            min_dist_factor=mc.min_dist_factor, margin=mc.margin,
        )
        return feed(m.idx_curr, m.mask)

    loop_time(p_match, "matcher")

    # ---- 4. PnP alone
    N = fe.max_raw_keypoints
    rng = np.random.default_rng(0)
    pts_w = jnp.asarray(np.stack(
        [rng.uniform(-20, 20, N), rng.uniform(-5, 5, N),
         rng.uniform(10, 60, N)], -1), jnp.float32)
    uv = jnp.asarray(rng.uniform(0, 1000, (N, 2)), jnp.float32)
    valid = jnp.asarray(rng.random(N) < 0.2)

    def p_pnp(s):
        res = pnp.solve_pnp_ransac(
            pts_w + s * 1e-9, uv, valid, K, jnp.eye(4, dtype=jnp.float32),
            key,
            n_hypotheses=pc.n_hypotheses, sample_size=pc.sample_size,
            inlier_px=pc.inlier_px,
            gn_iters_hypothesis=pc.gn_iters_hypothesis,
            gn_iters_refine=pc.gn_iters_refine, huber_px=pc.huber_px,
            prior_spread=pc.prior_spread,
        )
        return feed(res.T_c_w, res.n_inliers)

    loop_time(p_pnp, "PnP-RANSAC")


if __name__ == "__main__":
    main()
