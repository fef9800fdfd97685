"""Device-resident chunked SLAM core: equivalence with the host pipeline."""

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.config import Config


@pytest.fixture(scope="module")
def world():
    cfg = Config()
    return synthetic.make_world(cfg, n_frames=14, n_points=8000, seed=0)


def test_chunked_end_to_end(world, tmp_path):
    pose_path = str(tmp_path / "traj.txt")
    slam = ChunkedSlam(world.config, chunk=4, pose_path=pose_path)
    for f, left, right in synthetic.frames(world):
        if f >= 14:
            break
        slam.process(f, left, right)
    slam.finish()
    assert not slam.lost

    fids = sorted(slam.estimates.keys())
    assert len(fids) == 14 or len(fids) >= 12  # rejections possible
    est = np.stack([slam.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    ate = traj_mod.ate_rmse(est, gt)
    assert ate < 0.3, f"ATE {ate} too high"

    # per-frame records arrived for every frame
    assert len(slam.stats) == 14
    kf_count = sum(1 for s in slam.stats if s["keyframe"])
    assert kf_count >= 2
    # BA ran once the window filled
    if kf_count >= world.config.keyframe.window_size:
        assert any(s["ba_cost"] is not None for s in slam.stats)

    # trajectory file: one row per keyframe ever inserted, orthonormal R
    rows = traj_mod.read_trajectory(pose_path)
    assert len(rows) == kf_count
    for fid, T_w_c in rows.items():
        R = T_w_c[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_no_ba_is_truly_optimization_free(world):
    """enable_ba=False must reproduce the reference's "Without Optimization"
    semantics (README.md:92-94): the schedule never runs — no ba_cost, and
    crucially NO adaptive-chi2 writeback, so landmark is_inlier flags keep
    their spawn value (True) forever."""
    import dataclasses

    import jax

    cfg = world.config.replace(
        ba=dataclasses.replace(world.config.ba, enable_ba=False),
        keyframe=dataclasses.replace(world.config.keyframe, window_size=4),
    )
    slam = ChunkedSlam(cfg, chunk=4)
    for f, left, right in synthetic.frames(world):
        if f >= 14:
            break
        slam.process(f, left, right)
    slam.finish()
    assert not slam.lost
    kf_count = sum(1 for s in slam.stats if s["keyframe"])
    assert kf_count >= cfg.keyframe.window_size  # BA *would* have run
    assert all(s["ba_cost"] is None for s in slam.stats)

    m = jax.device_get(slam.carry.mstate)
    alive = m.obs_mask.max(axis=1) > 0
    assert alive.any()
    # spawn sets inlier=True; only the (skipped) BA verdict ever clears it
    assert m.inlier[alive].all()


def test_chunked_map_invariants(world):
    slam = ChunkedSlam(world.config, chunk=4)
    for f, left, right in synthetic.frames(world):
        if f >= 12:
            break
        slam.process(f, left, right)
    slam.finish()
    import jax

    m = jax.device_get(slam.carry.mstate)
    Kw = world.config.keyframe.window_size
    assert int(m.kf_count) <= Kw
    # live slots have frame ids, dead slots don't
    live = np.arange(Kw) < int(m.kf_count)
    assert (m.kf_frame_id[live] >= 0).all()
    assert (m.kf_frame_id[~live] == -1).all()
    # slots ordered oldest -> newest
    fids = m.kf_frame_id[live]
    assert (np.diff(fids) > 0).all()
    # observation grid only references live slots
    assert m.obs_mask[:, ~live].sum() == 0
    # every tracked feature's arena row carries an observation or was
    # just spawned (still referenced)
    t = jax.device_get(slam.carry.tstate)
    rows = t.lm_id[t.valid]
    assert (rows >= 0).all()
    assert (rows < world.config.ba.max_landmarks).all()


def test_packed_chunk_step_equals_unpacked():
    """The single-upload packed dispatch path (encode_chunk_buffer ->
    decode on device) is bit-identical to the three-array chunk step."""
    import jax
    import jax.numpy as jnp

    from stereo_visual_slam.data import synthetic
    from stereo_visual_slam.models import slam_core
    from stereo_visual_slam.utils.config import small_config

    cfg = small_config()
    H, W = cfg.padded_hw
    h, w = cfg.image_hw
    B = 4
    world = synthetic.make_world(cfg, n_frames=B, n_points=1500, seed=0)
    stacked = np.zeros((B, 2, H, W), np.uint8)
    for i, (f, l, r) in enumerate(synthetic.frames(world)):
        stacked[i, 0, :h, :w] = l
        stacked[i, 1, :h, :w] = r
    fids = np.arange(100, 100 + B, dtype=np.int32)
    active = np.array([1, 1, 1, 0], bool)
    key = jax.random.PRNGKey(0)
    carry = slam_core.init_carry(cfg)

    step = slam_core.make_chunk_step(cfg)
    c1, r1 = step(
        carry, jnp.asarray(stacked), jnp.asarray(fids), jnp.asarray(active),
        key,
    )
    packed = slam_core.make_chunk_step_packed(cfg, chunk=B)
    buf = jnp.asarray(slam_core.encode_chunk_buffer(stacked, fids, active))
    c2, r2 = packed(carry, buf, key)
    for a, b in zip(jax.tree.leaves((c1, r1)), jax.tree.leaves((c2, r2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_staged_run_matches_streaming():
    """ChunkedSlam.run(stage=True) — chunk buffers pre-uploaded, the
    offline/dataset mode — produces bit-identical estimates and stats to
    the live-streaming driver (uploads through the thread pool)."""
    from stereo_visual_slam.data import synthetic
    from stereo_visual_slam.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam.utils.config import small_config

    cfg = small_config()
    world = synthetic.make_world(cfg, n_frames=14, n_points=1500, seed=0)
    frames = [(f, l, r) for f, l, r in synthetic.frames(world)]

    staged = ChunkedSlam(cfg, chunk=6)
    staged.run(frames)
    staged.finish()
    streaming = ChunkedSlam(cfg, chunk=6)
    streaming.run(frames, stage=False)
    streaming.finish()

    assert sorted(staged.estimates) == sorted(streaming.estimates)
    for f in staged.estimates:
        np.testing.assert_array_equal(
            staged.estimates[f], streaming.estimates[f]
        )
    assert [s["state"] for s in staged.stats] == [
        s["state"] for s in streaming.stats
    ]

    # bounded stage-ahead (the long-dataset mode: at most window_chunks
    # buffers in device memory) is bit-identical too
    rolling = ChunkedSlam(cfg, chunk=6)
    rolling.run_rolling(frames, window_chunks=2)
    rolling.finish()
    assert sorted(rolling.estimates) == sorted(staged.estimates)
    for f in staged.estimates:
        np.testing.assert_array_equal(
            rolling.estimates[f], staged.estimates[f]
        )
    assert [s["state"] for s in rolling.stats] == [
        s["state"] for s in staged.stats
    ]
