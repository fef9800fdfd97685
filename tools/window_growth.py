"""Window growth on the device: ms/keyframe of the BA schedule at
Kw = 10/20/40 (landmark table scaled with the window), plus the per-device
compute time the same windows would cost sharded n ways (schedule at L/n —
the shard-local program; the only collective is one psum of the reduced
(6Kw x 6Kw + 6Kw) camera system per LM iteration, 14 KB at Kw=10 / 230 KB
at Kw=40).

Together with tools/scaling_bench.py (the 8-virtual-device CPU mesh wall
numbers for the full sharded program) this quantifies the north-star claim
that the active window can grow with host count (BASELINE.json configs[4],
SURVEY.md §5 long-context row): per-device time at (Kw, L/n) ~ constant
while the window scales n-fold.

Method: two-length fori with carry-fed data: the slope between r and 3r
iterations cancels the per-dispatch overhead.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from scaling_bench import make_window  # noqa: E402

from stereo_visual_slam.ba import schedule as ba_schedule  # noqa: E402
from stereo_visual_slam.utils.cache import enable_compilation_cache  # noqa: E402
from stereo_visual_slam.utils.config import BAConfig  # noqa: E402


def loop_time(body, r=6):
    runs = {}
    for n in (r, 3 * r):

        @jax.jit
        def run(s, n=n):
            return jax.lax.fori_loop(0, n, lambda i, c: body(c), s)

        jax.block_until_ready(run(jnp.zeros(())))
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(jnp.ones(())))
            best = min(best, time.perf_counter() - t0)
        runs[n] = best
    return (runs[3 * r] - runs[r]) / (2 * r)


def schedule_time(cfg, Kw, L):
    inp, K = make_window(L, nK=Kw, seed=1)
    run = ba_schedule.make_ba_schedule(cfg)

    def body(s):
        res = run(inp._replace(points=inp.points + s * 1e-30), K)
        return jnp.tanh(jnp.sum(res.T_c_w)) * 1e-20 + res.cost_full * 1e-30

    return loop_time(body)


def main():
    enable_compilation_cache()
    cfg = BAConfig(rel_tol=0.0)  # fixed iteration budget: comparable work

    print("# single-device window growth (device ms per BA schedule = per "
          "keyframe):", flush=True)
    base = None
    for Kw, L in ((10, 4096), (20, 8192), (40, 16384)):
        dt = schedule_time(cfg, Kw, L)
        if base is None:
            base = dt
        print(f"Kw={Kw:3d} L={L:6d}: {dt*1e3:8.2f} ms/keyframe  "
              f"({dt/base:4.2f}x the Kw=10 window)", flush=True)

    print("\n# shard-local per-device compute (schedule at L/n; + one "
          "psum of (6Kw)^2 f32 per LM iter):", flush=True)
    for Kw, L in ((20, 8192), (40, 16384)):
        for n in (1, 2, 4, 8):
            dt = schedule_time(cfg, Kw, L // n)
            psum_kb = (6 * Kw) ** 2 * 4 / 1024
            print(f"Kw={Kw:3d} L={L:6d} sharded x{n}: "
                  f"{dt*1e3:8.2f} ms/device  (psum {psum_kb:.0f} KB/iter)",
                  flush=True)


if __name__ == "__main__":
    main()
