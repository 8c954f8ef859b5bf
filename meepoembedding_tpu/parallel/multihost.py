"""Multi-host process-group utilities (SURVEY.md C15, L3; BASELINE config 5).

The reference class coordinates workers over NCCL/MPI + a remote KV; here
it is `jax.distributed` (process rendezvous) + XLA collectives inside the
jitted step — no hand-written transport. This module wraps
process-group init and the host-boundary data movements that differ between
single- and multi-process runs:

  init_distributed()      rendezvous; call once per process before device use
  shard_batch()           process-local numpy batch -> global sharded array
  all_processes_sum()     host-side scalar reduction (metrics)
  barrier()               sync point for checkpoint commit protocols
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the jax.distributed process group (multi-host rendezvous).
    No-ops in single-process runs (all args None and no cluster env)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def shard_batch(arr: np.ndarray, mesh, pspec) -> jax.Array:
    """Process-local batch slice -> global jax.Array sharded over the mesh.

    In single-process runs this is a plain device_put; in multi-process runs
    each host contributes its local rows (the input pipeline already shards
    lines per host, data/criteo.py) and the result is the GLOBAL batch."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, pspec)
    if not is_multiprocess():
        return jax.device_put(arr, sharding)
    return jax.make_array_from_process_local_data(sharding, arr)


def all_processes_sum(x: float) -> float:
    """Sum a host-side python scalar across processes (metrics aggregation)."""
    if not is_multiprocess():
        return float(x)
    from jax.experimental import multihost_utils

    return float(multihost_utils.process_allgather(np.float64(x)).sum())


def all_processes_max(x: float) -> float:
    """Max of a host-side python scalar across processes (round agreement)."""
    if not is_multiprocess():
        return float(x)
    from jax.experimental import multihost_utils

    return float(multihost_utils.process_allgather(np.float64(x)).max())


def barrier(name: str = "barrier") -> None:
    if is_multiprocess():
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)
