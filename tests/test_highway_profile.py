"""The highway synthetic profile — the KITTI seq-01 analog of the
reference's robustness claim (/root/reference/README.md:97: seq 01
"completed without lost"). ~2.7 m/frame forward speed (KITTI 01 averages
~2.5-2.8 m/frame at 10 Hz), sparse roadside structure, perspective sprite
scaling, mild sensor noise. Stresses large-baseline matching, per-frame
disparity change, and the keyframe rule under fast forward motion.
bench.py runs the >=200-frame version on the GPU with the same gate."""

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.config import Config

pytestmark = pytest.mark.slow

# >= 96 frames = ~260 m at 2.7 m/frame, so at least one standard KITTI
# sub-trajectory length (100 m) fits inside the CI gate itself
N = 96


@pytest.fixture(scope="module")
def world():
    return synthetic.make_world(
        Config(), n_frames=N, n_points=8000, seed=5, profile="highway"
    )


def test_highway_profile_ingredients(world):
    assert world.profile == "highway"
    # ~2.7 m/frame forward speed
    step = np.linalg.norm(
        world.poses_T_c_w[1][:3, 3] - world.poses_T_c_w[0][:3, 3]
    )
    assert 2.5 < step < 2.9, step
    # perspective sprite scaling + mild noise are on
    assert world.sizes is not None
    assert 0 < world.noise_sigma < 3.0
    # sparse roadside: no tall walls — barrier points stay below 1.4 m height
    wall = np.abs(world.points[:, 0]).max()
    assert wall < 30.0  # structure is bounded laterally


def test_highway_tracks_through(world):
    slam = ChunkedSlam(world.config, chunk=6)
    for f, left, right in synthetic.frames(world):
        slam.process(f, left, right)
    slam.finish()
    assert not slam.lost, "highway profile blew the Lost fuse"

    n_tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    assert n_tracked >= N - 2, (
        f"only {n_tracked}/{N} tracked: "
        f"{[(s['frame_id'], s['state']) for s in slam.stats]}"
    )
    fids = sorted(slam.estimates)
    est = np.stack([slam.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    t_err, _r_err = traj_mod.kitti_errors(est, gt)
    # the reference's seq-00 headline gate (README.md:92-95)
    assert t_err <= 4.17, f"highway trans error {t_err}%"
