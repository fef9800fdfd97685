"""Multi-host distributed runtime plumbing.

The reference is a single-process ROS node with no compute fabric
(SURVEY.md §2 "Parallelism & distributed communication"); here it is
`jax.distributed`, with XLA's collectives running over NCCL (NVLink between
the GPUs of a host, the network between hosts). This module is the one place
that touches process-level initialization: call `initialize_distributed()`
once at startup (the CLI's `--distributed` flag does), then build meshes
over `jax.devices()` — which, after initialization, spans every host's
GPUs — and let the landmark-sharded BA schedule (ba/schedule.py) ride the
collectives. The mesh is 1-D over the landmark axis; every GPU of a host
reaches every other at the same NVLink rate, so no device order matters.

Environment contract (standard JAX multi-process): set
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID, or pass them
explicitly; nothing is discovered automatically.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Idempotent jax.distributed.initialize with env-var fallbacks."""
    import jax

    if jax.distributed.is_initialized():
        return
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    nproc = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    pid = process_id if process_id is not None else os.environ.get(
        "JAX_PROCESS_ID"
    )
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def make_landmark_mesh(n_devices: int = 0):
    """A 1-D mesh over the landmark axis using the first n (default: all)
    visible devices — global across hosts after initialize_distributed."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("lm",))
