"""Reference-faithful configuration end-to-end.

The default config deviates from the reference in documented, benchmarked
ways (trimmed BA iteration maxima, matcher gate 45, motion-gated search,
gauge anchoring, upright BRIEF). This test pins the OTHER direction: a
configuration dialed back to the reference's published constants —
2x5/10/10 BA schedule (run_vslam.cpp:61-70), base gate 30
(visual_odometry.cpp:242), no search-radius gate, no margin, steered
descriptors (cv::ORB), no gauge anchor — must still track the synthetic
sequence and land within tolerance of the default config's trajectory.
"""

import dataclasses

import numpy as np
import pytest

from stereo_visual_slam.data import synthetic
from stereo_visual_slam.pipeline import trajectory as traj_mod
from stereo_visual_slam.pipeline.chunked import ChunkedSlam
from stereo_visual_slam.utils.config import Config, reference_ba_schedule

N = 14


def reference_faithful(cfg: Config) -> Config:
    return cfg.replace(
        frontend=dataclasses.replace(cfg.frontend, steer_descriptor=True),
        matcher=dataclasses.replace(
            cfg.matcher, base_gate=30.0, margin=0.0, search_radius=1e6
        ),
        ba=dataclasses.replace(
            reference_ba_schedule(cfg.ba), fix_oldest_pose=False
        ),
    )


@pytest.fixture(scope="module")
def rendered():
    world = synthetic.make_world(Config(), n_frames=N, n_points=8000, seed=0)
    return world, [(f, l, r) for f, l, r in synthetic.frames(world)]


def test_reference_faithful_config_tracks(rendered):
    world, frames = rendered
    cfg_ref = reference_faithful(Config())
    assert cfg_ref.ba.classify_passes == 2
    assert cfg_ref.ba.full_iters == 10

    results = {}
    for name, cfg in (("default", Config()), ("reference", cfg_ref)):
        slam = ChunkedSlam(cfg, chunk=7)
        for f, l, r in frames:
            slam.process(f, l, r)
        slam.finish()
        assert not slam.lost, name
        n_tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
        # steered rBRIEF (the reference's descriptor) is weaker on this
        # world (see ops/orb.py describe); one marginal rejection is fine
        assert n_tracked >= N - 1, (name, n_tracked)
        fids = sorted(slam.estimates)
        est = np.stack([slam.estimates[f] for f in fids])
        results[name] = (
            {f: slam.estimates[f] for f in fids},
            traj_mod.ate_rmse(est, world.poses_T_c_w[fids]),
        )

    # both configurations are accurate, and they agree with each other
    for name, (_, ate) in results.items():
        assert ate < 0.35, (name, ate)
    common = sorted(set(results["default"][0]) & set(results["reference"][0]))
    for f in common:
        d = np.linalg.norm(
            np.linalg.inv(results["default"][0][f])[:3, 3]
            - np.linalg.inv(results["reference"][0][f])[:3, 3]
        )
        assert d < 0.3, f"frame {f}: configs diverge by {d} m"
