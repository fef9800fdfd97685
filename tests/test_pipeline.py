"""End-to-end pipeline tests on synthetic sequences (CPU)."""

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.vo import VisualOdometry
from stereo_visual_slam.utils.config import Config


@pytest.fixture(scope="module")
def world():
    cfg = Config()
    return synthetic.make_world(cfg, n_frames=14, n_points=8000, seed=0)


def run_vo(world, n, **kw):
    vo = VisualOdometry(world.config, **kw)
    for f, left, right in synthetic.frames(world):
        if f >= n:
            break
        rec = vo.process(f, left, right)
        assert rec["state"] != "lost"
    vo.finish()
    return vo


def test_tracking_no_ba(world):
    vo = run_vo(world, 8, enable_ba=False)
    fids = sorted(vo.estimates.keys())
    assert len(fids) == 8
    est = np.stack([vo.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    ate = traj_mod.ate_rmse(est, gt)
    assert ate < 0.3, f"ATE {ate} too high"


def test_tracking_with_ba(world, tmp_path):
    pose_path = str(tmp_path / "traj.txt")
    vo = run_vo(world, 14, enable_ba=True, pose_path=pose_path)
    fids = sorted(vo.estimates.keys())
    est = np.stack([vo.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    ate = traj_mod.ate_rmse(est, gt)
    assert ate < 0.3, f"ATE {ate} too high"

    # trajectory file: reference format, one row per keyframe, parseable
    rows = traj_mod.read_trajectory(pose_path)
    assert len(rows) == vo.next_kf_id
    for fid, T_w_c in rows.items():
        R = T_w_c[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        # matches the in-memory estimate
        np.testing.assert_allclose(
            T_w_c, np.linalg.inv(vo.estimates[fid]), atol=1e-3
        )


def test_map_window_bounded(world):
    vo = run_vo(world, 14, enable_ba=False)
    assert vo.map.n_keyframes() <= world.config.keyframe.window_size
    # every live landmark must be observed by at least one active keyframe
    alive = vo.map.alive
    assert (vo.map.obs_count[alive] > 0).all()
    # arena bookkeeping consistent: id table round-trips
    rows = np.nonzero(alive)[0]
    ids = vo.map.row_id[rows]
    assert (vo.map.rows_of(ids) == rows).all()


def test_pose_row_format():
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    row = traj_mod.format_pose_row(7, np.linalg.inv(T))
    parts = row.split()
    assert len(parts) == 13
    assert parts[0] == "7"
    vals = [float(x) for x in parts[1:]]
    assert vals[3] == 1.0 and vals[7] == 2.0 and vals[11] == 3.0
