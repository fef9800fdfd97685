"""Persistent XLA compilation cache.

The chunk program takes long to compile; with the cache, later processes
load it instead. Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its
cache there and this module sets no directory; otherwise the cache lives
at the fixed `<checkout>/.jax_cache`.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = DEFAULT_DIR
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
