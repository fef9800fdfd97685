"""Focused device-time experiments for the three hot spots: stereo strip
construction, corner top-k, and BA marginal iteration cost."""

import time

import jax
import jax.numpy as jnp
import numpy as np

from stereo_visual_slam.ba import schur_lm
from stereo_visual_slam.utils.cache import enable_compilation_cache
from stereo_visual_slam.utils.config import Config

R = 30


def loop_time(body, label, r=R):
    @jax.jit
    def run(s):
        return jax.lax.fori_loop(0, r, lambda i, c: body(c), s)

    jax.block_until_ready(run(jnp.zeros(())))
    t0 = time.perf_counter()
    jax.block_until_ready(run(jnp.ones(())))
    dt = (time.perf_counter() - t0) / r
    print(f"{label:52s} {dt*1e3:8.3f} ms", flush=True)
    return dt


def feed(x):
    return jnp.tanh(jnp.sum(x)) * 1e-20


def main():
    enable_compilation_cache()
    cfg = Config()
    rng = np.random.default_rng(0)
    H, W = cfg.padded_hw
    left = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    right = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    N = cfg.frontend.max_raw_keypoints
    D, p = 96, 11
    r_half = p // 2
    yxN = jnp.asarray(rng.integers(24, 350, (N, 2)), jnp.int32)

    left_p = jnp.pad(left, r_half)
    right_p = jnp.pad(right, ((r_half, r_half), (D + r_half, r_half)))
    y = yxN[:, 0]
    x = yxN[:, 1]

    # 1a. strip construction via vmapped dynamic_slice (current)
    def strips_dyn(s):
        lp = jax.vmap(
            lambda yy, xx: jax.lax.dynamic_slice(
                left_p + s, (yy, xx), (p, p))
        )(y, x)
        strip = jax.vmap(
            lambda yy, xx: jax.lax.dynamic_slice(
                right_p, (yy, xx + 1), (p, p + D - 1))
        )(y, x)
        return feed(lp) + feed(strip)
    loop_time(strips_dyn, "stereo: strips via vmap dynamic_slice")

    # 1b. window materialization via advanced-index gather (current)
    lp = jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(left_p, (yy, xx), (p, p))
    )(y, x)
    strip = jax.vmap(
        lambda yy, xx: jax.lax.dynamic_slice(
            right_p, (yy, xx + 1), (p, p + D - 1))
    )(y, x)
    starts = (D - 1) - jnp.arange(D)
    cols = starts[:, None] + jnp.arange(p)[None, :]

    def win_gather(s):
        win = (strip + s)[:, :, cols]
        return feed(win)
    loop_time(win_gather, "stereo: window gather (N,p,D,p)")

    def win_slices(s):
        st = strip + s
        parts = [
            jax.lax.slice_in_dim(st, (D - 1 - d), (D - 1 - d) + p, axis=2)
            for d in range(D)
        ]
        win = jnp.stack(parts, axis=1)
        return feed(win)
    loop_time(win_slices, "stereo: window via D static slices")

    # 1c. zncc einsum alone
    win = jnp.transpose(strip[:, :, cols], (0, 2, 1, 3))
    lpn = lp / 255.0

    def zncc_only(s):
        w = win + s
        wm = w - jnp.mean(w, axis=(2, 3), keepdims=True)
        wn = wm / (jnp.sqrt(jnp.sum(wm * wm, axis=(2, 3), keepdims=True)) + 1e-6)
        return feed(jnp.einsum("npq,ndpq->nd", lpn, wn))
    loop_time(zncc_only, "stereo: normalize + zncc einsum")

    # 2. top-k variants over the L0 score map
    flat = left.reshape(-1)

    def topk_exact(s):
        sc, idx = jax.lax.top_k(flat + s, 512)
        return feed(sc) + feed(idx.astype(jnp.float32))
    loop_time(topk_exact, "top_k exact 512 of 491K")

    def topk_approx(s):
        sc, idx = jax.lax.approx_max_k(
            flat + s, 512, recall_target=0.95)
        return feed(sc) + feed(idx.astype(jnp.float32))
    loop_time(topk_approx, "approx_max_k 512 of 491K (r=0.95)")

    def topk_2stage(s):
        # exact-ish: block max then top_k over maxima, then recover
        v = (flat + s).reshape(-1, 8)
        bm = jnp.max(v, axis=1)
        ba = jnp.argmax(v, axis=1)
        sc, bi = jax.lax.top_k(bm, 512)
        idx = bi * 8 + ba[bi]
        return feed(sc) + feed(idx.astype(jnp.float32))
    loop_time(topk_2stage, "2-stage top_k (block-8 max)")

    # 3. BA marginal iteration cost
    Kw, L = cfg.keyframe.window_size, cfg.ba.max_landmarks
    ptsL = jnp.asarray(np.stack(
        [rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
         rng.uniform(10, 60, L)], -1), jnp.float32)
    Ts = jnp.tile(jnp.eye(4, dtype=jnp.float32), (Kw, 1, 1))
    uvw = jnp.asarray(rng.uniform(0, 1000, (L, Kw, 2)), jnp.float32)
    ones_l = jnp.ones((L,), jnp.float32)
    Kmat = jnp.asarray(
        [[cfg.camera.fx, 0, cfg.camera.cx],
         [0, cfg.camera.fy, cfg.camera.cy], [0, 0, 1]], jnp.float32)
    prob = schur_lm.BAProblem(
        T_c_w=Ts, points=ptsL, uv=uvw,
        obs_mask=jnp.ones((L, Kw), jnp.float32), point_mask=ones_l,
        pose_mask=jnp.ones((Kw,), jnp.float32),
        fixed_pose=jnp.zeros((Kw,), jnp.float32).at[0].set(1.0))

    for iters in (1, 2, 4, 8):
        def ba_body(s, iters=iters):
            res = schur_lm.lm_optimize(
                prob._replace(points=ptsL + s), Kmat, iters=iters,
                rel_tol=0.0)
            return feed(res.T_c_w) + feed(res.cost)
        loop_time(ba_body, f"lm_optimize iters={iters} (rel_tol=0)", r=10)

    # pose-only-style: update_points=False
    def ba_np(s):
        res = schur_lm.lm_optimize(
            prob._replace(points=ptsL + s), Kmat, iters=4,
            update_points=False, rel_tol=0.0)
        return feed(res.T_c_w) + feed(res.cost)
    loop_time(ba_np, "lm_optimize iters=4 no-points", r=10)

    for Lsub in (2048, 1024):
        sub = prob._replace(
            points=ptsL[:Lsub], uv=uvw[:Lsub],
            obs_mask=jnp.ones((Lsub, Kw), jnp.float32),
            point_mask=ones_l[:Lsub])

        def ba_sub(s, sub=sub, Lsub=Lsub):
            res = schur_lm.lm_optimize(
                sub._replace(points=sub.points + s), Kmat, iters=4,
                rel_tol=0.0)
            return feed(res.T_c_w) + feed(res.cost)
        loop_time(ba_sub, f"lm_optimize iters=4 L={Lsub}", r=10)


if __name__ == "__main__":
    main()
