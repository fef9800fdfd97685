import jax
import jax.numpy as jnp
import numpy as np

from stereo_visual_slam.ba import pose_only, schur_lm
from stereo_visual_slam.geom import se3

FX, FY, CX, CY = 718.856, 718.856, 607.1928, 185.2157
K = jnp.asarray([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], jnp.float32)


def make_ba_problem(
    rng,
    n_kf=6,
    n_lm=150,
    pose_noise=0.02,
    point_noise=0.3,
    px_noise=0.3,
    n_outlier_lm=0,
):
    """Ground-truth window: camera drives forward, landmarks ahead."""
    pts_gt = np.stack(
        [
            rng.uniform(-25, 25, n_lm),
            rng.uniform(-6, 6, n_lm),
            rng.uniform(15, 80, n_lm),
        ],
        axis=-1,
    ).astype(np.float32)
    T_gt = []
    for k in range(n_kf):
        tau = np.array(
            [0.05 * k, 0.0, -1.2 * k, 0.0, 0.01 * k, 0.0], np.float32
        )
        T_gt.append(np.asarray(se3.exp(jnp.asarray(tau))))
    T_gt = np.stack(T_gt)

    # observations: project with GT; mask points behind camera / off image
    Xc = np.einsum("kij,lj->lki", T_gt[:, :3, :3], pts_gt) + T_gt[:, :3, 3][None]
    uv = np.stack(
        [
            FX * Xc[..., 0] / Xc[..., 2] + CX,
            FY * Xc[..., 1] / Xc[..., 2] + CY,
        ],
        axis=-1,
    )
    obs_mask = (
        (Xc[..., 2] > 1.0)
        & (uv[..., 0] > 0) & (uv[..., 0] < 1241)
        & (uv[..., 1] > 0) & (uv[..., 1] < 376)
    ).astype(np.float32)
    uv = uv + rng.normal(0, px_noise, uv.shape)

    # corrupt some landmarks' observations (outliers for the classifier to
    # find). Offsets are per-OBSERVATION: a consistent offset across views
    # would be absorbed by moving the 3D point.
    outlier_idx = rng.choice(n_lm, n_outlier_lm, replace=False)
    uv[outlier_idx] += rng.uniform(40, 120, (n_outlier_lm, n_kf, 2)) * rng.choice(
        [-1, 1], (n_outlier_lm, n_kf, 2)
    )

    # noisy initialization
    T_init = np.stack(
        [
            np.asarray(
                se3.exp(jnp.asarray(rng.normal(0, pose_noise, 6), jnp.float32))
                @ jnp.asarray(T)
            )
            for T in T_gt
        ]
    )
    # Two anchored poses: stereo BA over pure reprojection still has a global
    # scale gauge freedom about a single fixed camera; anchoring two poses
    # pins it (the pipeline instead pins scale by never writing optimized
    # landmarks back, mirroring run_vslam.cpp:64 if_update_landmark=false).
    T_init[0] = T_gt[0]
    T_init[1] = T_gt[1]
    pts_init = pts_gt + rng.normal(0, point_noise, pts_gt.shape).astype(np.float32)

    fixed = np.zeros(n_kf, np.float32)
    fixed[0] = 1.0
    fixed[1] = 1.0
    problem = schur_lm.BAProblem(
        T_c_w=jnp.asarray(T_init, jnp.float32),
        points=jnp.asarray(pts_init, jnp.float32),
        uv=jnp.asarray(uv, jnp.float32),
        obs_mask=jnp.asarray(obs_mask),
        point_mask=jnp.ones(n_lm, jnp.float32),
        pose_mask=jnp.ones(n_kf, jnp.float32),
        fixed_pose=jnp.asarray(fixed),
    )
    return problem, jnp.asarray(T_gt), jnp.asarray(pts_gt), outlier_idx


def pose_rmse(T_est, T_gt):
    d = se3.log(T_est @ jnp.linalg.inv(T_gt))
    return float(jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1))))


def test_ba_converges_to_ground_truth(rng):
    problem, T_gt, pts_gt, _ = make_ba_problem(rng, px_noise=0.0)
    before = pose_rmse(problem.T_c_w, T_gt)
    res = schur_lm.lm_optimize(problem, K, iters=15)
    after = pose_rmse(res.T_c_w, T_gt)
    assert after < before * 0.05, (before, after)
    assert after < 5e-4
    # well-observed landmarks land on GT (single-observation points are
    # unconstrained along their viewing ray — skip them)
    n_obs = np.asarray(problem.obs_mask).sum(axis=1)
    lm_err = np.asarray(jnp.linalg.norm(res.points - pts_gt, axis=-1))
    assert lm_err[n_obs >= 2].max() < 0.05


def test_ba_cost_decreases(rng):
    problem, *_ = make_ba_problem(rng, px_noise=0.5)
    res1 = schur_lm.lm_optimize(problem, K, iters=1)
    res10 = schur_lm.lm_optimize(problem, K, iters=10)
    assert float(res10.cost) <= float(res1.cost)


def test_ba_outlier_classification(rng):
    """Two classify passes, mirroring the reference BA schedule
    (run_vslam.cpp:61-62): optimize -> drop flagged landmarks -> optimize."""
    problem, T_gt, pts_gt, out_idx = make_ba_problem(
        rng, px_noise=0.3, n_outlier_lm=15
    )
    res1 = schur_lm.lm_optimize(problem, K, iters=5)
    inl1 = np.asarray(res1.landmark_inlier)
    assert not inl1[out_idx].any(), "corrupted landmarks not flagged in pass 1"
    # pass 2 without the flagged landmarks (poses/points NOT written back,
    # like the reference's if_update_map=false classify passes)
    problem2 = problem._replace(
        point_mask=problem.point_mask * jnp.asarray(inl1, jnp.float32)
    )
    res2 = schur_lm.lm_optimize(problem2, K, iters=5)
    inl2 = np.asarray(res2.landmark_inlier) & inl1
    clean = np.setdiff1d(np.arange(150), out_idx)
    assert not inl2[out_idx].any()
    assert inl2[clean].mean() > 0.9, inl2[clean].mean()


def test_ba_respects_fixed_pose(rng):
    problem, T_gt, *_ = make_ba_problem(rng)
    res = schur_lm.lm_optimize(problem, K, iters=10)
    np.testing.assert_allclose(
        np.asarray(res.T_c_w[0]), np.asarray(problem.T_c_w[0]), atol=1e-6
    )


def test_ba_masked_landmarks_unchanged(rng):
    problem, *_ = make_ba_problem(rng)
    pm = np.ones(150, np.float32)
    pm[:20] = 0.0
    problem = problem._replace(point_mask=jnp.asarray(pm))
    res = schur_lm.lm_optimize(problem, K, iters=5)
    np.testing.assert_allclose(
        np.asarray(res.points[:20]), np.asarray(problem.points[:20]), atol=1e-6
    )


def test_pose_only_converges(rng):
    problem, T_gt, pts_gt, _ = make_ba_problem(
        rng, pose_noise=0.02, point_noise=0.0, px_noise=0.0
    )
    # landmarks at GT, only poses perturbed -> pose-only must recover them
    problem = problem._replace(points=pts_gt)
    before = pose_rmse(problem.T_c_w, T_gt)
    res = pose_only.optimize_pose_only(problem, K, iters=10)
    after = pose_rmse(res.T_c_w, T_gt)
    assert after < before * 0.05, (before, after)
    assert after < 5e-4


def test_pose_only_landmarks_never_move(rng):
    problem, *_ = make_ba_problem(rng)
    res = pose_only.optimize_pose_only(problem, K, iters=5)
    assert not hasattr(res, "points")  # API: poses only
