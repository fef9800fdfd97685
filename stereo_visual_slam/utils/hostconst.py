"""Keep closure-captured constants OFF the accelerator.

Every `make_*` builder in this package eagerly creates small jnp arrays
(intrinsics matrices, BRIEF pattern tables, FAST ring offsets, GN
perturbation grids, ...) that end up captured by the jitted closures. At
trace/lower time JAX embeds each captured jax.Array constant into the MLIR
module by FETCHING its value back from whatever device it lives on
(`_array_mlir_constant_handler` -> `array._value`); the chunk program
captures hundreds of these, each a separate device->host copy.

`build_on_host` runs a builder under `jax.default_device(<host cpu>)`: the
captured constants materialize in HOST memory and constant embedding at
lowering is a local memcpy (the compiled program is bit-identical —
constants are inlined into the HLO either way). Runtime state (the SLAM
carry, uploaded image buffers) is unaffected: it is created outside the
builders and explicitly device_put. Whether this still buys anything on a
GPU host is open (ROADMAP 3.2).
"""

from __future__ import annotations

import functools


def host_cpu_device():
    """The host CPU device, or None when no CPU backend is registered."""
    import jax

    try:
        return jax.local_devices(backend="cpu")[0]
    except Exception:
        return None


def build_on_host(builder):
    """Decorator: run `builder` (a make_* closure factory) with the host CPU
    as the default device, so eager jnp constants created while building
    stay in host memory instead of on the accelerator."""

    @functools.wraps(builder)
    def wrapped(*args, **kwargs):
        import jax

        cpu = host_cpu_device()
        if cpu is None:
            return builder(*args, **kwargs)
        with jax.default_device(cpu):
            return builder(*args, **kwargs)

    return wrapped
