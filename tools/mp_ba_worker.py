"""Worker for the true multi-process `jax.distributed` test.

Launched twice (process_id 0/1) by tests/test_multiprocess.py with a
localhost coordinator. Each process owns 4 virtual CPU devices; the global
mesh spans 8 devices across both processes. The landmark-sharded BA
schedule (ba/schedule.py shard_map path) runs over that global mesh — each
process's devices reduce their local landmarks' Schur contributions and the
reduced camera system psum rides the (here: gRPC-backed) collective fabric,
the same layout that spans NCCL across GPU hosts (SURVEY.md §7 step 7).

The result is cross-checked against the single-device schedule computed
locally; success prints MP_OK.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.experimental.multihost_utils as mhu  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402


def make_window(cfg, L):
    """Deterministic synthetic BA window (identical on every process)."""
    from stereo_visual_slam.ba import schedule as ba_schedule

    rng = np.random.default_rng(0)
    cam = cfg.camera
    Kw = cfg.keyframe.window_size
    pts = np.stack(
        [rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
         rng.uniform(10, 60, L)], -1)
    Ts = []
    for k in range(Kw):
        T = np.eye(4, dtype=np.float64)
        T[:3, 3] = [0.02 * k + rng.normal(0, 0.01), rng.normal(0, 0.01),
                    -0.8 * k]
        Ts.append(T)
    Ts = np.asarray(Ts, np.float32)
    uv = np.zeros((L, Kw, 2), np.float32)
    for k in range(Kw):
        Xc = pts @ np.asarray(Ts[k, :3, :3], np.float64).T + Ts[k, :3, 3]
        z = np.maximum(Xc[:, 2], 1e-3)
        uv[:, k, 0] = cam.fx * Xc[:, 0] / z + cam.cx
        uv[:, k, 1] = cam.fy * Xc[:, 1] / z + cam.cy
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    out_rows = rng.uniform(size=L) < 0.05
    uv[out_rows] += rng.uniform(20, 60, (int(out_rows.sum()), Kw, 2))

    ones_l = np.ones((L,), np.float32)
    fixed = np.zeros((Kw,), np.float32)
    fixed[0] = 1.0
    return ba_schedule.ScheduleInput(
        T_c_w=Ts,
        points=pts.astype(np.float32),
        uv=uv.astype(np.float32),
        obs_mask=np.ones((L, Kw), np.float32),
        inlier=ones_l,
        reliable=ones_l,
        present=ones_l,
        pose_mask=np.ones((Kw,), np.float32),
        fixed_pose=fixed,
    )


def main():
    coord, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from stereo_visual_slam.utils.dist import initialize_distributed

    initialize_distributed(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 4 * nproc, len(devs)

    from stereo_visual_slam.ba import schedule as ba_schedule
    from stereo_visual_slam.utils.config import Config

    cfg = Config()
    L = 1024
    cam = cfg.camera
    K_np = np.asarray(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32
    )
    inp_np = make_window(cfg, L)

    mesh = Mesh(np.asarray(devs), (ba_schedule.LM_AXIS,))
    LM = ba_schedule.LM_AXIS
    lm_specs = ba_schedule.ScheduleInput(
        T_c_w=P(), points=P(LM), uv=P(LM), obs_mask=P(LM), inlier=P(LM),
        reliable=P(LM), present=P(LM), pose_mask=P(), fixed_pose=P(),
    )

    def to_global(arr, spec):
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
        )

    inp_g = jax.tree.map(to_global, inp_np, lm_specs)
    K_g = to_global(K_np, P())

    sched_sharded = jax.jit(ba_schedule.make_ba_schedule(cfg.ba, mesh=mesh))
    res = sched_sharded(inp_g, K_g)
    T_sharded = np.asarray(mhu.process_allgather(res.T_c_w, tiled=True))
    cost_g = np.asarray(
        mhu.process_allgather(res.cost_full, tiled=True)
    ).ravel()
    assert np.allclose(cost_g, cost_g[0])
    cost_sharded = float(cost_g[0])

    # single-device reference on a local device
    sched_single = ba_schedule.make_ba_schedule(cfg.ba)
    local0 = jax.local_devices()[0]
    res_ref = sched_single(
        jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), local0), inp_np),
        jax.device_put(jnp.asarray(K_np), local0),
    )
    T_ref = np.asarray(res_ref.T_c_w)
    cost_ref = float(res_ref.cost_full)

    assert np.allclose(T_sharded, T_ref, atol=2e-4), (
        np.abs(T_sharded - T_ref).max()
    )
    assert abs(cost_sharded - cost_ref) <= 1e-3 * max(abs(cost_ref), 1.0), (
        cost_sharded, cost_ref
    )
    print(f"MP_OK pid={pid} cost={cost_ref:.4f}", flush=True)


if __name__ == "__main__":
    main()
