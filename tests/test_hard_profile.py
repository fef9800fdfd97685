"""The --hard synthetic profile: per-frame sensor noise + exposure drift,
independently moving occluders, a low-texture stretch, perspective sprite
scaling, and a sharp ~80-degree turn (data/synthetic.py make_world
profile="hard"). The tracker must survive all of it — the CI-scale analog
of the reference's KITTI seq 00 robustness claim (README.md:97 "without
lost"); bench.py runs the full-length version on the GPU.
"""

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.config import Config

pytestmark = pytest.mark.slow

N = 45  # covers the low-texture stretch (25-37%) and the sharp turn (55%+)


@pytest.fixture(scope="module")
def world():
    return synthetic.make_world(
        Config(), n_frames=N, n_points=8000, seed=3, profile="hard"
    )


def test_hard_profile_ingredients(world):
    assert world.profile == "hard"
    assert world.noise_sigma > 0 and world.gain_amp > 0
    assert world.occ_pos is not None and world.sizes is not None
    # the low-texture stretch really removed points (shoved underground);
    # the stretch spans ~4 % of the extended path at this frame count
    assert (world.points[:, 1] > 1e5).sum() > 150
    # photometrics actually vary between frames
    l1, _ = synthetic.render_frame(world, 10)
    l2, _ = synthetic.render_frame(world, 16)
    assert abs(float(l1.mean()) - float(l2.mean())) > 0.5


def test_hard_profile_tracks_through(world):
    slam = ChunkedSlam(world.config, chunk=5)
    for f, left, right in synthetic.frames(world):
        slam.process(f, left, right)
    slam.finish()
    assert not slam.lost, "hard profile blew the Lost fuse"

    n_tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    assert n_tracked >= N - 4, (
        f"only {n_tracked}/{N} tracked: "
        f"{[(s['frame_id'], s['state']) for s in slam.stats]}"
    )
    fids = sorted(slam.estimates)
    est = np.stack([slam.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    ate = traj_mod.ate_rmse(est, gt)
    assert ate < 0.8, f"hard-profile ATE {ate}"
