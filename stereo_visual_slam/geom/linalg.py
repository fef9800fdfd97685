"""Small batched linear solves in closed form.

`jnp.linalg.solve` / `cholesky` lower to library calls or elimination loops,
each a separate launch, which adds up in a loop that solves one small
system per iteration (PnP Gauss-Newton, LM damping retries). These
closed-form inverses are pure elementwise math: they fuse into the
surrounding kernel, batched over any leading dimensions.

Numerics: closed-form adjugate inverses are exact in infinite precision but
amplify rounding for ill-conditioned inputs; every caller here inverts a
DAMPED normal-equation block (A + lambda I with lambda >= 1e-6 scaled to the
diagonal), which bounds the condition number to ~diag/lambda. Residual
evaluation downstream is exact f32, and the surrounding LM/GN acceptance
logic rejects any step a poor solve produces.
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3x3(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = e * i - f * h
    c12 = c * h - b * i
    c13 = b * f - c * e
    c21 = f * g - d * i
    c22 = a * i - c * g
    c23 = c * d - a * f
    c31 = d * h - e * g
    c32 = b * g - a * h
    c33 = a * e - b * d
    det = a * c11 + b * c21 + c * c31
    inv_det = 1.0 / jnp.where(jnp.abs(det) > eps, det, jnp.sign(det) * eps + eps)
    return (
        jnp.stack(
            [
                jnp.stack([c11, c12, c13], axis=-1),
                jnp.stack([c21, c22, c23], axis=-1),
                jnp.stack([c31, c32, c33], axis=-1),
            ],
            axis=-2,
        )
        * inv_det[..., None, None]
    )


def _mm3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) @ (..., 3, 3) as elementwise mul + reduce: f32-exact at
    any matmul precision, fuses with its neighbours."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def inv6x6(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 6x6 inverse via 3x3-block Schur complement.

        A = [A11 A12; A21 A22],  S = A22 - A21 A11^-1 A12
        A^-1 = [A11^-1 + B S^-1 C,  -B S^-1;  -S^-1 C,  S^-1]
        with B = A11^-1 A12, C = A21 A11^-1.

    Valid when A11 and S are invertible — true for the damped SPD
    normal-equation blocks this is used on.
    """
    A11, A12 = A[..., :3, :3], A[..., :3, 3:]
    A21, A22 = A[..., 3:, :3], A[..., 3:, 3:]
    i11 = inv3x3(A11)
    B = _mm3(i11, A12)
    C = _mm3(A21, i11)
    S = A22 - _mm3(A21, B)
    iS = inv3x3(S)
    BiS = _mm3(B, iS)
    B11 = i11 + _mm3(BiS, C)
    B12 = -BiS
    B21 = -_mm3(iS, C)
    return jnp.concatenate(
        [
            jnp.concatenate([B11, B12], axis=-1),
            jnp.concatenate([B21, iS], axis=-1),
        ],
        axis=-2,
    )


def solve6(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 6x6 solve A x = b via the closed-form inverse.
    A (..., 6, 6), b (..., 6) -> (..., 6). Elementwise contraction (no matmul)
    so the result is f32-exact at any matmul precision."""
    return jnp.sum(inv6x6(A) * b[..., None, :], axis=-1)


def _mm6(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., 6, 6) @ (..., 6, 6) elementwise."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _mv6(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., 6, 6) @ (..., 6) elementwise."""
    return jnp.sum(a * b[..., None, :], axis=-1)


def solve_block_spd(S: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve the damped-SPD block system S x = b where S is (K, 6, K, 6)
    and b is (K, 6), by UNROLLED block Gaussian elimination with 6x6 pivot
    blocks inverted in closed form.

    An alternative to `jnp.linalg.solve` on the reshaped (6K, 6K) matrix
    that unrolls to a few hundred fused elementwise ops.
    No pivoting — valid because every caller damps the diagonal
    (Levenberg-Marquardt), making S positive definite.
    """
    K = S.shape[0]
    A = jnp.swapaxes(S, 1, 2)          # (K, K, 6, 6): A[i][j] block row i
    rows = [A[i] for i in range(K)]    # each (K, 6, 6)
    rhs = [b[i] for i in range(K)]     # each (6,)
    dinv = [None] * K
    for j in range(K):
        dinv[j] = inv6x6(rows[j][j])
        if j + 1 < K:
            below = jnp.stack([rows[i][j] for i in range(j + 1, K)])
            F = _mm6(below, dinv[j])                    # (K-j-1, 6, 6)
            upd = _mm6(F[:, None], rows[j][None, j:])   # (K-j-1, K-j, 6, 6)
            rhs_upd = _mv6(F, rhs[j][None, :])          # (K-j-1, 6)
            for n, i in enumerate(range(j + 1, K)):
                rows[i] = rows[i].at[j:].add(-upd[n])
                rhs[i] = rhs[i] - rhs_upd[n]
    x = [None] * K
    for j in reversed(range(K)):
        acc = rhs[j]
        if j + 1 < K:
            xs = jnp.stack(x[j + 1:])                   # (K-j-1, 6)
            acc = acc - jnp.sum(_mv6(rows[j][j + 1:], xs), axis=0)
        x[j] = _mv6(dinv[j], acc)
    return jnp.stack(x)
