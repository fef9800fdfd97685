"""Distributed-BA scaling: the full BA schedule landmark-sharded over
1/2/4/8 devices (virtual CPU mesh here; the same shard_map path runs over
NCCL on GPUs).

Communication per LM iteration is one psum of the reduced (6K x 6K + 6K)
camera system (~15 KB at K=10) regardless of map size, so the per-landmark
einsums — the FLOPs — scale with 1/n_devices.

Usage: python tools/scaling_bench.py [L] [obs_per_lm]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__":
    # force the 8-virtual-device CPU mesh ONLY when run as a script; other
    # tools (window_growth.py) import make_window without touching platform
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from stereo_visual_slam.ba import schedule as ba_schedule  # noqa: E402
from stereo_visual_slam.geom import se3  # noqa: E402
from stereo_visual_slam.utils.config import BAConfig  # noqa: E402


def make_window(L, nK=10, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
         rng.uniform(10, 80 + nK, L)], axis=-1,
    ).astype(np.float32)
    T = np.stack([
        np.asarray(se3.exp(jnp.asarray(
            [0.02 * k, 0.0, -1.0 * k, 0.0, 0.004 * k, 0.0], jnp.float32)))
        for k in range(nK)
    ]).astype(np.float32)
    fx = fy = 718.856
    cx, cy = 607.1928, 185.2157
    K = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)
    Xc = np.einsum("kij,lj->lki", T[:, :3, :3], pts) + T[:, :3, 3][None]
    z = np.maximum(Xc[..., 2], 1e-3)
    uv = np.stack(
        [fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], axis=-1
    ).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    obs = (Xc[..., 2] > 1.0).astype(np.float32)
    ones = np.ones(L, np.float32)
    fixed = np.zeros(nK, np.float32)
    fixed[0] = 1.0
    inp = ba_schedule.ScheduleInput(
        T_c_w=jnp.asarray(T),
        points=jnp.asarray(
            pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
        ),
        uv=jnp.asarray(uv),
        obs_mask=jnp.asarray(obs),
        inlier=jnp.asarray(ones),
        reliable=jnp.asarray(ones),
        present=jnp.asarray(ones),
        pose_mask=jnp.ones(nK, jnp.float32),
        fixed_pose=jnp.asarray(fixed),
    )
    return inp, K


def time_schedule(cfg, inp, K, mesh, reps=3):
    run = jax.jit(ba_schedule.make_ba_schedule(cfg, mesh=mesh))
    out = run(inp, K)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(inp, K)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def main():
    L = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    inp, K = make_window(L)
    cfg = BAConfig(rel_tol=0.0)  # fixed iteration count: comparable work
    print(f"# BA schedule scaling, L={L} landmarks x 10 keyframes, "
          f"fixed iteration budget")
    base = None
    for n in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:n]), (ba_schedule.LM_AXIS,))
        dt, out = time_schedule(cfg, inp, K, mesh)
        if base is None:
            base = dt
        print(f"devices={n}: {dt*1e3:8.1f} ms/schedule   "
              f"speedup {base/dt:4.2f}x   cost {float(out.cost_full):.1f}")

    # ---- window GROWTH: hold per-device work ~constant while the active
    # window and landmark table scale with the mesh — the "long-context"
    # analog of SURVEY.md §5: an 8-device mesh sustains a 4x window at
    # roughly single-device-per-chunk cost.
    print("\n# window growth: (Kw, L) scaled with devices, "
          "1-device vs 8-device wall")
    for Kw, Lw in ((10, 4096), (20, 8192), (40, 16384)):
        inp_w, K_w = make_window(Lw, nK=Kw)
        t1, o1 = time_schedule(
            cfg, inp_w, K_w,
            Mesh(np.array(jax.devices()[:1]), (ba_schedule.LM_AXIS,)))
        t8, o8 = time_schedule(
            cfg, inp_w, K_w,
            Mesh(np.array(jax.devices()[:8]), (ba_schedule.LM_AXIS,)))
        print(f"Kw={Kw:3d} L={Lw:6d}: 1-dev {t1*1e3:8.1f} ms  "
              f"8-dev {t8*1e3:8.1f} ms  speedup {t1/t8:4.2f}x  "
              f"cost {float(o8.cost_full):.1f}")


if __name__ == "__main__":
    main()
