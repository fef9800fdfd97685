"""The tracking-failure machinery — the reference's main robustness
mechanism (check_motion_estimation, visual_odometry.cpp:316-346; frame-gap
gate scaling, visual_odometry.cpp:239,328; Lost fuse,
visual_odometry.cpp:649-706).

Scenarios driven here:
  * a garbage frame is REJECTED, the pose is held, tracking recovers;
  * rejections grow the frame gap, so the re-acquisition frame passes the
    scaled motion gate (5 * gap) even though its motion exceeds the
    single-frame gate;
  * >max_lost consecutive failures blow the Lost fuse in both drivers;
  * the chunked device core and the host oracle agree through a
    rejection-and-recovery sequence.
"""

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.pipeline.vo import VisualOdometry
from stereo_visual_slam.utils.config import Config

N_FRAMES = 16
GARBAGE_AT = 8


@pytest.fixture(scope="module")
def world():
    return synthetic.make_world(
        Config(), n_frames=N_FRAMES, n_points=8000, seed=2
    )


@pytest.fixture(scope="module")
def rendered(world):
    """Pre-render once for all tests in this module."""
    return [(f, l, r) for f, l, r in synthetic.frames(world)]


def _garbage_like(img: np.ndarray, seed=99) -> np.ndarray:
    """A structureless noise frame: plenty of FAST corners, no coherent
    geometry — matches are spurious, PnP consensus collapses."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, img.shape).astype(np.float32)


def test_chunked_rejection_and_recovery(world, rendered):
    slam = ChunkedSlam(world.config, chunk=4)
    for f, left, right in rendered:
        if f == GARBAGE_AT:
            left = _garbage_like(left, seed=7)
            right = _garbage_like(right, seed=8)
        slam.process(f, left, right)
    slam.finish()
    assert not slam.lost

    by_fid = {s["frame_id"]: s for s in slam.stats}
    assert by_fid[GARBAGE_AT]["state"] == "rejected"
    # the rejected frame produced no trajectory estimate
    assert GARBAGE_AT not in slam.estimates
    # recovery: every later frame tracked
    for f in range(GARBAGE_AT + 1, N_FRAMES):
        assert by_fid[f]["state"] == "tracked", by_fid[f]

    # accuracy unharmed by the rejection
    fids = sorted(slam.estimates.keys())
    est = np.stack([slam.estimates[f] for f in fids])
    ate = traj_mod.ate_rmse(est, world.poses_T_c_w[fids])
    assert ate < 0.3, ate


def test_frame_gap_gate_growth(world, rendered):
    """3 consecutive rejections grow the gap to 4; the re-acquisition frame
    moved ~4 m since the last ACCEPTED frame — over the single-frame twist
    gate (5 * 1) would still pass, but the matcher search radius and gate
    must also scale, and the recovery frame must be accepted with the
    reference's gap semantics (visual_odometry.cpp:239,328)."""
    slam = ChunkedSlam(world.config, chunk=4)
    reject_span = (6, 7, 8)
    for f, left, right in rendered:
        if f in reject_span:
            left = _garbage_like(left, seed=100 + f)
            right = _garbage_like(right, seed=200 + f)
        slam.process(f, left, right)
    slam.finish()
    assert not slam.lost

    by_fid = {s["frame_id"]: s for s in slam.stats}
    for f in reject_span:
        assert by_fid[f]["state"] == "rejected"
    # recovery frame: accepted, with twist ~len(reject_span)+1 metres —
    # possible only because the gate scaled with the gap
    rec = by_fid[reject_span[-1] + 1]
    assert rec["state"] == "tracked"
    assert rec["twist"] > world.config.pnp.max_twist * 0.5, (
        "recovery twist should reflect the accumulated gap motion"
    )
    for f in range(reject_span[-1] + 1, N_FRAMES):
        assert by_fid[f]["state"] == "tracked"


def test_lost_fuse_chunked(world, rendered):
    """max_lost consecutive failures blow the fuse
    (visual_odometry.cpp:663: num_lost_ > 10 -> Lost)."""
    cfg = world.config
    slam = ChunkedSlam(cfg, chunk=4)
    # 4 good frames to initialize + track, then garbage until the fuse blows
    n_garbage = cfg.keyframe.max_lost + 2
    for f, left, right in rendered[:4]:
        slam.process(f, left, right)
    for i in range(n_garbage):
        f = 4 + i
        slam.process(
            f,
            _garbage_like(rendered[0][1], seed=300 + i),
            _garbage_like(rendered[0][2], seed=400 + i),
        )
    slam.finish()
    assert slam.lost
    lost_frames = [s for s in slam.stats if s["state"] == "lost"]
    assert lost_frames, "a frame should be flagged lost"
    # the fuse blew after exactly max_lost+1 consecutive rejections
    first_lost = min(s["frame_id"] for s in lost_frames)
    assert first_lost == 4 + cfg.keyframe.max_lost
    # feeding more frames after Lost is a no-op
    n_stats = len(slam.stats)
    slam.process(99, rendered[0][1], rendered[0][2])
    slam.finish()
    assert len(slam.stats) == n_stats


def test_host_chunked_equivalence_with_rejections(world, rendered):
    """The chunked device core and the host oracle take the same
    accept/reject decisions and produce matching trajectories through a
    rejection."""
    cfg = world.config

    slam = ChunkedSlam(cfg, chunk=4)
    vo = VisualOdometry(cfg, lookahead=0)
    for f, left, right in rendered:
        if f == GARBAGE_AT:
            left = _garbage_like(left, seed=7)
            right = _garbage_like(right, seed=8)
        slam.process(f, left, right)
        vo.process(f, left, right)
    slam.finish()
    vo.finish()

    def norm(s):  # the host driver labels frame 0 "init"
        return "tracked" if s == "init" else s

    ch = {s["frame_id"]: norm(s["state"]) for s in slam.stats}
    ho = {s["frame_id"]: norm(s["state"]) for s in vo.stats}
    assert ch == ho, f"accept/reject decisions diverge: {ch} vs {ho}"

    common = sorted(set(slam.estimates) & set(vo.estimates))
    assert len(common) >= N_FRAMES - 3
    for f in common:
        d = np.linalg.norm(
            np.linalg.inv(slam.estimates[f])[:3, 3]
            - np.linalg.inv(vo.estimates[f])[:3, 3]
        )
        assert d < 0.2, f"frame {f}: drivers diverge by {d} m"
