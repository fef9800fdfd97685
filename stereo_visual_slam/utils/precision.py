"""Matmul-precision control.

On the GPU, f32 matmuls at default precision may run in TF32 (~1e-3
relative error); geometry and bundle-adjustment math is tiny (3x3 .. 60x60)
but precision-critical in float32, so those code paths run under
`jax.default_matmul_precision("highest")` (full f32). Descriptor matching
keeps the fast default: Hamming matching is exact anyway because +-1
products are exactly representable and accumulation is forced to f32 via
preferred_element_type.
"""

from __future__ import annotations

import functools

import jax


def precise(fn):
    """Decorator: run `fn` (and everything it traces) at highest matmul
    precision."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
