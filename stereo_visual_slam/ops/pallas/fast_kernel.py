"""FAST-9/16 score map as a Pallas kernel on the Triton route (GPU).

Each program computes one (bh, bw) block of the score map from 17 shifted
block loads of the zero-padded image (the centre and the 16 circle
pixels), so the image is read once from device memory per block plus its
3-pixel halo, which the L1/L2 caches serve. The arc test uses a doubling
network: min over 9 contiguous circle diffs as 4 levels of pairwise min,
and the dark pass as max. f32 min/max are exact, so the result equals
`ops/fast.fast_score_map` bit for bit (the tests assert it in interpret
mode). 3x3 NMS stays in XLA (`ops/fast.nms_3x3`), which fuses it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from stereo_visual_slam.ops.fast import CIRCLE_OFFSETS

_R = 3  # circle radius


def _arc9(vals, op):
    """op over the 9 contiguous circle entries starting at each of the 16."""
    m2 = [op(vals[i], vals[(i + 1) % 16]) for i in range(16)]
    m4 = [op(m2[i], m2[(i + 2) % 16]) for i in range(16)]
    m8 = [op(m4[i], m4[(i + 4) % 16]) for i in range(16)]
    return [op(m8[i], vals[(i + 8) % 16]) for i in range(16)]


def _fast_kernel(img_ref, out_ref, *, bh, bw, threshold):
    r0 = pl.program_id(0) * bh + _R
    c0 = pl.program_id(1) * bw + _R

    def at(dy, dx):
        return img_ref[pl.ds(r0 + dy, bh), pl.ds(c0 + dx, bw)]

    center = at(0, 0)
    diffs = [at(dy, dx) - center for dy, dx in CIRCLE_OFFSETS]
    # bright: the arc's weakest diff must exceed the threshold; dark: the
    # arc's largest diff must be below -threshold
    best_bright = functools.reduce(jnp.maximum, _arc9(diffs, jnp.minimum))
    worst_dark = functools.reduce(jnp.minimum, _arc9(diffs, jnp.maximum))
    sb = jnp.where(best_bright > threshold, best_bright, 0.0)
    sd = jnp.where(-worst_dark > threshold, -worst_dark, 0.0)
    out_ref[...] = jnp.maximum(sb, sd)


@functools.partial(
    jax.jit,
    static_argnames=("threshold", "block", "num_warps", "interpret"),
)
def fast_score_map(
    img: jnp.ndarray,
    threshold: float,
    *,
    block=(16, 64),
    num_warps: int = 4,
    interpret: bool = False,
) -> jnp.ndarray:
    """Dense FAST-9/16 score map of an (H, W) f32 image, zero where not a
    corner; equal to `ops.fast.fast_score_map(img, threshold)`. Any H, W:
    the image is zero-padded up to whole blocks and the result cropped."""
    H, W = img.shape
    bh, bw = block
    Hb, Wb = pl.cdiv(H, bh) * bh, pl.cdiv(W, bw) * bw
    padded = jnp.pad(
        img.astype(jnp.float32), ((_R, _R + Hb - H), (_R, _R + Wb - W))
    )
    out = pl.pallas_call(
        functools.partial(_fast_kernel, bh=bh, bw=bw, threshold=threshold),
        grid=(Hb // bh, Wb // bw),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((bh, bw), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((Hb, Wb), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="fast_score_map",
    )(padded)
    return out[:H, :W]
