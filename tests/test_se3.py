import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_visual_slam.geom import se3


def random_twists(rng, n=64, scale=1.0):
    return jnp.asarray(rng.normal(size=(n, 6)) * scale, dtype=jnp.float32)


def test_exp_log_roundtrip(rng):
    tau = random_twists(rng, scale=0.5)
    tau2 = se3.log(se3.exp(tau))
    np.testing.assert_allclose(np.asarray(tau2), np.asarray(tau), atol=2e-5)


def test_exp_log_roundtrip_tiny(rng):
    tau = random_twists(rng, scale=1e-5)
    tau2 = se3.log(se3.exp(tau))
    np.testing.assert_allclose(np.asarray(tau2), np.asarray(tau), atol=1e-7)


def test_exp_log_roundtrip_large_angle(rng):
    tau = random_twists(rng, scale=1.0)
    tau = tau.at[:, 3:].mul(2.5)  # rotation angles up to ~pi
    T = se3.exp(tau)
    T2 = se3.exp(se3.log(T))
    np.testing.assert_allclose(np.asarray(T2), np.asarray(T), atol=1e-4)


def test_inverse_compose(rng):
    tau = random_twists(rng, scale=0.5)
    T = se3.exp(tau)
    eye = se3.compose(T, se3.inverse(T))
    np.testing.assert_allclose(
        np.asarray(eye), np.broadcast_to(np.eye(4), eye.shape), atol=1e-5
    )


def test_rotation_orthonormal(rng):
    T = se3.exp(random_twists(rng, scale=1.0))
    R = se3.rotation(T)
    RtR = np.asarray(jnp.swapaxes(R, -1, -2) @ R)
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-5)


def test_act_matches_matmul(rng):
    T = se3.exp(random_twists(rng, n=8, scale=0.5))
    pts = jnp.asarray(rng.normal(size=(8, 3)), dtype=jnp.float32)
    out = se3.act(T, pts)
    hom = jnp.concatenate([pts, jnp.ones((8, 1), jnp.float32)], axis=-1)
    expected = jnp.einsum("nij,nj->ni", T, hom)[:, :3]
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), atol=1e-5)


def test_left_multiplicative_update_convention(rng):
    """The BA solver updates T <- exp(delta) @ T (g2o VertexPose::oplusImpl,
    optimization.cpp:26-32). Check exp(d)@T moves the pose by d in the world
    frame for small d."""
    T = se3.exp(random_twists(rng, n=1, scale=0.3))[0]
    d = jnp.asarray([1e-3, 0, 0, 0, 0, 0], jnp.float32)
    T2 = se3.exp(d) @ T
    np.testing.assert_allclose(
        np.asarray(se3.translation(T2) - se3.translation(T)),
        [1e-3, 0, 0],
        atol=1e-6,
    )


def test_known_rotation():
    # 90 degrees about z
    tau = jnp.asarray([0, 0, 0, 0, 0, np.pi / 2], jnp.float32)
    R = se3.rotation(se3.exp(tau))
    expected = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32)
    np.testing.assert_allclose(np.asarray(R), expected, atol=1e-6)


def test_pure_translation():
    tau = jnp.asarray([1.0, 2.0, 3.0, 0, 0, 0], jnp.float32)
    T = se3.exp(tau)
    np.testing.assert_allclose(np.asarray(se3.translation(T)), [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(se3.rotation(T)), np.eye(3), atol=1e-6
    )


def test_angle_y():
    yaw = 0.05
    tau = jnp.asarray([0, 0, 0, 0, yaw, 0], jnp.float32)
    T = se3.exp(tau)
    assert abs(float(se3.angle_y(T)) - yaw) < 1e-5
    # sign-insensitive (reference bug workaround: we use |angle|)
    T2 = se3.exp(-tau)
    assert abs(float(se3.angle_y(T2)) - yaw) < 1e-5


def test_normalize_rotation(rng):
    T = se3.exp(random_twists(rng, n=4, scale=0.5))
    # perturb rotation slightly off the manifold
    T = T.at[..., :3, :3].add(
        jnp.asarray(rng.normal(size=(4, 3, 3)) * 1e-3, jnp.float32)
    )
    Tn = se3.normalize_rotation(T)
    R = se3.rotation(Tn)
    RtR = np.asarray(jnp.swapaxes(R, -1, -2) @ R)
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-5)


def test_jit_and_grad():
    f = jax.jit(lambda tau: jnp.sum(se3.exp(tau) ** 2))
    tau = jnp.asarray([0.1, 0.2, 0.3, 0.01, 0.02, 0.03], jnp.float32)
    g = jax.grad(f)(tau)
    # finite differences
    eps = 1e-3
    for i in range(6):
        tp = tau.at[i].add(eps)
        tm = tau.at[i].add(-eps)
        fd = (f(tp) - f(tm)) / (2 * eps)
        assert abs(float(g[i]) - float(fd)) < 1e-2
