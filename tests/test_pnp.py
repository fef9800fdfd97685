import jax
import jax.numpy as jnp
import numpy as np

from stereo_visual_slam.geom import se3
from stereo_visual_slam.tracking import pnp

FX, FY, CX, CY = 718.856, 718.856, 607.1928, 185.2157
K = jnp.asarray([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], jnp.float32)


def make_scene(rng, n=200, outlier_frac=0.0, noise_px=0.0):
    """World points ahead of an identity camera; GT pose is a small motion."""
    pts = np.stack(
        [
            rng.uniform(-20, 20, n),
            rng.uniform(-5, 5, n),
            rng.uniform(8, 60, n),
        ],
        axis=-1,
    ).astype(np.float32)
    tau = np.array([0.3, -0.1, 0.8, 0.01, 0.03, -0.005], np.float32)
    T_gt = se3.exp(jnp.asarray(tau))
    Xc = np.asarray(se3.act(T_gt, jnp.asarray(pts)))
    uv = np.stack(
        [FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], axis=-1
    )
    uv += rng.normal(0, noise_px, uv.shape)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(30, 200, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    valid = np.ones(n, bool)
    return (
        jnp.asarray(pts),
        jnp.asarray(uv.astype(np.float32)),
        jnp.asarray(valid),
        T_gt,
        out_idx,
    )


def pose_error(T_est, T_gt):
    d = se3.log(se3.compose(T_est, se3.inverse(T_gt)))
    return float(jnp.linalg.norm(d))


def test_pnp_clean(rng):
    pts, uv, valid, T_gt, _ = make_scene(rng)
    res = pnp.solve_pnp_ransac(
        pts, uv, valid, K, se3.identity(), jax.random.PRNGKey(0)
    )
    assert pose_error(res.T_c_w, T_gt) < 1e-3
    assert int(res.n_inliers) >= 195


def test_pnp_with_outliers(rng):
    pts, uv, valid, T_gt, out_idx = make_scene(rng, outlier_frac=0.3)
    res = pnp.solve_pnp_ransac(
        pts, uv, valid, K, se3.identity(), jax.random.PRNGKey(1)
    )
    assert pose_error(res.T_c_w, T_gt) < 2e-3
    inl = np.asarray(res.inlier_mask)
    assert not inl[out_idx].any(), "outliers classified as inliers"
    assert inl.sum() >= 0.95 * (200 - len(out_idx))


def test_pnp_noisy(rng):
    pts, uv, valid, T_gt, _ = make_scene(rng, outlier_frac=0.2, noise_px=0.5)
    res = pnp.solve_pnp_ransac(
        pts, uv, valid, K, se3.identity(), jax.random.PRNGKey(2)
    )
    assert pose_error(res.T_c_w, T_gt) < 5e-3


def test_pnp_respects_validity_mask(rng):
    pts, uv, valid, T_gt, _ = make_scene(rng, n=100)
    # corrupt half the points but mark them invalid
    uv_bad = np.asarray(uv).copy()
    uv_bad[:50] += 500.0
    valid = jnp.asarray(np.arange(100) >= 50)
    res = pnp.solve_pnp_ransac(
        pts, jnp.asarray(uv_bad), valid, K, se3.identity(), jax.random.PRNGKey(3)
    )
    assert pose_error(res.T_c_w, T_gt) < 2e-3
    assert not np.asarray(res.inlier_mask)[:50].any()


def test_pnp_degenerate_returns_prior(rng):
    """With no valid points, the prior pose must come back unchanged."""
    pts, uv, valid, T_gt, _ = make_scene(rng, n=50)
    T_prior = se3.exp(jnp.asarray([0.1, 0, 0.5, 0, 0, 0], jnp.float32))
    res = pnp.solve_pnp_ransac(
        pts, uv, jnp.zeros(50, bool), K, T_prior, jax.random.PRNGKey(4)
    )
    assert int(res.n_inliers) == 0
    np.testing.assert_allclose(
        np.asarray(res.T_c_w), np.asarray(T_prior), atol=1e-6
    )


def test_pnp_bad_prior_recovery(rng):
    """A deliberately WRONG motion prior (3.5 m + attitude error away from
    the truth): prior-perturbed hypothesis starts (prior_spread > 0) must
    recover the pose where the pure-prior RANSAC collapses into the wrong
    GN basin — the diversity role of the reference's prior-free minimal
    solves (cv::solvePnPRansac, visual_odometry.cpp:277)."""
    pts, uv, valid, T_gt, _ = make_scene(rng, outlier_frac=0.2, noise_px=0.3)
    bad = se3.compose(
        se3.exp(jnp.asarray([1.8, -0.8, -2.8, 0.05, 0.08, -0.04],
                            jnp.float32)),
        T_gt,
    )
    res_div = pnp.solve_pnp_ransac(
        pts, uv, valid, K, bad, jax.random.PRNGKey(2), prior_spread=1.5
    )
    assert pose_error(res_div.T_c_w, T_gt) < 5e-3, (
        f"diverse starts failed: err={pose_error(res_div.T_c_w, T_gt)}, "
        f"inliers={int(res_div.n_inliers)}"
    )
    assert int(res_div.n_inliers) >= 120

    res_flat = pnp.solve_pnp_ransac(
        pts, uv, valid, K, bad, jax.random.PRNGKey(2), prior_spread=0.0
    )
    # the spread must help: strictly more consensus than the pure prior
    assert int(res_div.n_inliers) >= int(res_flat.n_inliers)
