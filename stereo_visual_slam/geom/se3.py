"""SE(3)/SO(3) Lie group core in pure jax.numpy.

Replaces the reference's Sophus usage (library_include.hpp:14-19). Conventions
match Sophus / g2o as used by the reference:

  * twists are 6-vectors ``[upsilon (trans), omega (rot)]`` (Sophus order),
  * pose updates are LEFT-multiplicative, ``T <- exp(delta) * T``
    (VertexPose::oplusImpl, optimization.cpp:26-32),
  * poses are stored as 4x4 homogeneous matrices ``T_c_w`` (world -> camera).

Everything is shape-polymorphic over leading batch dims via vmap-free
broadcasting where easy, and safe in float32 (Taylor fallbacks near theta=0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stereo_visual_slam.utils.precision import precise

_EPS = 1e-8
_SMALL = 1e-6  # theta^2 below this -> Taylor series


def hat(omega: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


@precise
def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < _SMALL
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(omega)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


@precise
def rotation_to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> unit quaternion (..., 4) [w, x, y, z], w >= 0.

    Branch-free Shepperd: compute all four candidate forms, pick the one with
    the largest pivot — numerically stable for every angle including pi."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    # four candidates, each scaled by its own pivot
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 0.0)) * 0.5
    s0 = 0.25 / jnp.maximum(qw0, _EPS)
    c0 = jnp.stack([qw0, (r21 - r12) * s0, (r02 - r20) * s0, (r10 - r01) * s0], -1)

    qx1 = jnp.sqrt(jnp.maximum(1.0 + r00 - r11 - r22, 0.0)) * 0.5
    s1 = 0.25 / jnp.maximum(qx1, _EPS)
    c1 = jnp.stack([(r21 - r12) * s1, qx1, (r01 + r10) * s1, (r02 + r20) * s1], -1)

    qy2 = jnp.sqrt(jnp.maximum(1.0 - r00 + r11 - r22, 0.0)) * 0.5
    s2 = 0.25 / jnp.maximum(qy2, _EPS)
    c2 = jnp.stack([(r02 - r20) * s2, (r01 + r10) * s2, qy2, (r12 + r21) * s2], -1)

    qz3 = jnp.sqrt(jnp.maximum(1.0 - r00 - r11 + r22, 0.0)) * 0.5
    s3 = 0.25 / jnp.maximum(qz3, _EPS)
    c3 = jnp.stack([(r10 - r01) * s3, (r02 + r20) * s3, (r12 + r21) * s3, qz3], -1)

    pivots = jnp.stack([tr, r00 - r11 - r22, -r00 + r11 - r22, -r00 - r11 + r22], -1)
    choice = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, choice[..., None, None].repeat(4, -1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    return q * jnp.where(q[..., :1] >= 0, 1.0, -1.0)


@precise
def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 3), via quaternion — stable at every angle."""
    q = rotation_to_quaternion(R)
    w, xyz = q[..., 0], q[..., 1:]
    n = jnp.linalg.norm(xyz, axis=-1)
    theta = 2.0 * jnp.arctan2(n, w)
    # theta / n with Taylor fallback (n = sin(theta/2))
    small = n < 1e-6
    scale = jnp.where(small, 2.0 + theta * theta / 12.0, theta / jnp.maximum(n, _EPS))
    return xyz * scale[..., None]


@precise
def _left_jacobian(omega: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian V such that exp([v, w])_trans = V @ v."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < _SMALL
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    W = hat(omega)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


@precise
def _left_jacobian_inv(omega: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < _SMALL
    half = theta * 0.5
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.where(small, 1.0, jnp.sin(half))) / theta2,
    )
    W = hat(omega)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * W2


@precise
def exp(tau: jnp.ndarray) -> jnp.ndarray:
    """se(3) exp: (..., 6) twist [v, w] -> (..., 4, 4)."""
    v, w = tau[..., :3], tau[..., 3:]
    R = so3_exp(w)
    t = jnp.einsum("...ij,...j->...i", _left_jacobian(w), v)
    return make(R, t)


@precise
def log(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = jnp.einsum("...ij,...j->...i", _left_jacobian_inv(w), t)
    return jnp.concatenate([v, w], axis=-1)


def make(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble 4x4 from (..., 3, 3) and (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


@precise
def inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


@precise
def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return A @ B


@precise
def act(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...j->...i", R, pts) + t


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def angle_y(T: jnp.ndarray) -> jnp.ndarray:
    """|rotation about camera Y| — the 'yaw while driving' used by the
    keyframe rule (T_c_l_.angleY() < 0.03, visual_odometry.cpp:353). We use
    |log(R)_y|, which agrees with Euler-Y to first order for the small
    inter-frame rotations of VO."""
    return jnp.abs(so3_log(rotation(T))[..., 1])


@precise
def normalize_rotation(T: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize the rotation block (float32 drift control) via
    symmetric orthogonalization (SVD-free, two Newton steps of the polar
    decomposition: R <- R (3I - R^T R)/2)."""
    R = T[..., :3, :3]
    for _ in range(2):
        RtR = jnp.swapaxes(R, -1, -2) @ R
        eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), RtR.shape)
        R = R @ (1.5 * eye - 0.5 * RtR)
    return make(R, T[..., :3, 3])
