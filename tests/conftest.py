"""Test harness: an 8-device virtual CPU mesh, set before jax is imported.

Unit tests run on the CPU (JAX_PLATFORMS=cpu unless the environment sets
it); distributed tests use the 8 virtual devices, mirroring how the
multi-device path is rehearsed without GPUs. Tests marked `gpu` need the
card and skip elsewhere: `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu`.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from stereo_visual_slam.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()  # reruns of the suite start warm

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
