"""Image utilities: padding, box blur, patch gather.

All fixed-shape, jit-friendly. Images are float32 (H, W) in [0, 255].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def pad_to(img: jnp.ndarray, hw) -> jnp.ndarray:
    """Pad (h, w) image with zeros to the static padded shape."""
    h, w = img.shape[-2:]
    H, W = hw
    return jnp.pad(img, [(0, H - h), (0, W - w)])


def box_blur(img: jnp.ndarray, k: int = 5) -> jnp.ndarray:
    """Separable k x k box blur as k static shifted adds per axis, which XLA
    fuses into elementwise work. Matches the integral-image smoothing BRIEF
    uses before sampling."""
    r = k // 2

    def blur_axis(x, axis):
        n = x.shape[axis]
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        xp = jnp.pad(x, pad, mode="edge")
        acc = jax.lax.slice_in_dim(xp, 0, n, axis=axis)
        for s in range(1, k):
            acc = acc + jax.lax.slice_in_dim(xp, s, s + n, axis=axis)
        return acc / k

    return blur_axis(blur_axis(img, 0), 1)


@functools.partial(jax.jit, static_argnums=(2,))
def gather_patches(img: jnp.ndarray, yx: jnp.ndarray, patch: int) -> jnp.ndarray:
    """Extract `patch` x `patch` windows centered at integer coords yx (N, 2)
    as one batched dynamic slice per keypoint; values are the image's f32
    values. Out-of-range centers are clamped (callers mask by validity).
    Returns (N, patch, patch) float32.

    An earlier formulation gathered through two one-hot bf16 matmuls, which
    rounded the patch values to bf16. Upright BRIEF is bit-identical either
    way, because `orb.describe_patches` casts patches to bf16 before its
    matmul; steered BRIEF computes orientations from the f32 values and can
    pick another angle bin than the rounded patches did.
    """
    P = patch
    r = P // 2
    H, W = img.shape
    y0 = jnp.clip(yx[:, 0] - r, 0, H - P)
    x0 = jnp.clip(yx[:, 1] - r, 0, W - P)
    return jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(img, (y, x), (P, P))
    )(y0, x0).astype(jnp.float32)


def gather_values(img: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """img[(y, x)] for integer coords (N, 2), clamped."""
    H, W = img.shape
    y = jnp.clip(yx[:, 0], 0, H - 1)
    x = jnp.clip(yx[:, 1], 0, W - 1)
    return img[y, x]
