"""Device mesh + multi-host process-group setup (SURVEY.md C15).

The reference class's communication backend is NCCL between GPUs plus
RPC/Redis to remote storage (README.md:2 "distributed"). Here: XLA
collectives (NCCL on GPUs) emitted from `shard_map`ped code — no
hand-written transport. This module owns mesh construction and
`jax.distributed` initialization; every collective in the framework is
emitted by XLA from `shard_map`ped code.

Axis convention: a single axis `"d"` carries BOTH data parallelism (the
batch is sharded over it) and table row-sharding (each device owns one
TableShard) — the standard hybrid layout for embedding models, where the
all-to-all ID exchange (SURVEY.md C13) rides the same axis.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "d"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Multi-host rendezvous (SURVEY.md §3.1). No-op when single-process;
    with only COORDINATOR_ADDRESS set, `jax.distributed.initialize()` reads
    the rest of the cluster from the environment. Safe to call twice."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif os.environ.get("COORDINATOR_ADDRESS"):
        jax.distributed.initialize()


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the first `num_devices`) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (SHARD_AXIS,))


def shard_spec() -> P:
    return P(SHARD_AXIS)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for stacked per-device state [S, ...]."""
    return NamedSharding(mesh, P(SHARD_AXIS))
