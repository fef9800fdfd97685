"""Multi-scale pyramid detection (cv::ORB 8-level / 1.2-factor analog,
visual_odometry.cpp:22).

The scale scenario: head-on approach to a wall of physically-sized sprites
(data/synthetic.py make_wall_world) with a mid-sequence rejection stretch.
Re-acquisition then has to match descriptors across a ~27 % appearance
scale change — a single-scale extractor decorrelates, the pyramid keeps a
level pair aligned within one 1.2x scale step.
"""

import dataclasses

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.config import Config

N_FRAMES = 14
GARBAGE = (7, 8, 9)


@pytest.fixture(scope="module")
def rendered():
    world = synthetic.make_wall_world(
        Config(), n_frames=N_FRAMES, speed=2.2, wall_z=42.0, seed=0
    )
    return world, [(f, l, r) for f, l, r in synthetic.frames(world)]


def _run(cfg, rendered):
    world, frames = rendered
    rng = np.random.default_rng(0)
    slam = ChunkedSlam(cfg, chunk=3)
    for f, l, r in frames:
        if f in GARBAGE:
            l = rng.uniform(0, 255, l.shape).astype(np.float32)
            r = rng.uniform(0, 255, r.shape).astype(np.float32)
        slam.process(f, l, r)
    slam.finish()
    by_fid = {s["frame_id"]: s for s in slam.stats}
    reacq = by_fid[GARBAGE[-1] + 1]
    recovered = [
        by_fid[f]["state"] == "tracked"
        for f in range(GARBAGE[-1] + 1, N_FRAMES)
    ]
    return slam, recovered, reacq


def test_pyramid_levels_detect(rendered):
    """Coarse levels contribute real keypoints on the scaled-sprite wall."""
    import jax.numpy as jnp

    from stereo_visual_slam.models import frontend as fm

    world, frames = rendered
    cfg = Config()
    ext = fm.make_extractor(cfg)
    H, W = cfg.padded_hw
    left, right = frames[0][1], frames[0][2]
    pad = lambda im: jnp.asarray(
        np.pad(im, ((0, H - im.shape[0]), (0, W - im.shape[1]))), jnp.float32
    )
    feats = ext(pad(left), pad(right))
    scale = np.asarray(feats.scale)
    valid = np.asarray(feats.valid)
    n_coarse = int((valid & (scale > 1.4)).sum())
    assert n_coarse > 30, f"coarse levels found only {n_coarse} keypoints"
    # full-res coords stay inside the valid image
    yx = np.asarray(feats.yx)[valid]
    assert (yx[:, 0] < cfg.image_hw[0]).all()
    assert (yx[:, 1] < cfg.image_hw[1]).all()


def test_pyramid_survives_scale_change_where_single_scale_degrades(rendered):
    """Re-acquisition across a ~1.6x appearance-scale jump (gap-4 rejection
    stretch during a fast wall approach): the pyramid re-acquires with a
    large consensus; single-scale is marginal (an order fewer inliers,
    scraping the min_inliers=10 gate)."""
    cfg_pyr = Config()
    fe1 = dataclasses.replace(cfg_pyr.frontend, n_levels=1)
    cfg_one = cfg_pyr.replace(frontend=fe1)

    slam_pyr, rec_pyr, reacq_pyr = _run(cfg_pyr, rendered)
    slam_one, rec_one, reacq_one = _run(cfg_one, rendered)

    # pyramid: solid recovery after the gap, accurate through the approach
    assert all(rec_pyr), f"pyramid failed to re-acquire: {rec_pyr}"
    assert reacq_pyr["state"] == "tracked"
    assert reacq_pyr["n_inliers"] >= 50, reacq_pyr
    world = rendered[0]
    fids = sorted(slam_pyr.estimates)
    est = np.stack([slam_pyr.estimates[f] for f in fids])
    ate = traj_mod.ate_rmse(est, world.poses_T_c_w[fids])
    assert ate < 0.5, ate

    # single-scale: at least 4x weaker consensus across the scale jump
    one_inl = reacq_one["n_inliers"] if reacq_one["state"] == "tracked" else 0
    assert one_inl * 4 <= reacq_pyr["n_inliers"], (
        f"single-scale re-acquired with {one_inl} vs pyramid "
        f"{reacq_pyr['n_inliers']} — scenario not stressful enough"
    )
