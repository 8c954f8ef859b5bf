"""meepoembedding_tpu — a dynamic (lookuptable-style) embedding engine in JAX.

A from-scratch JAX/XLA design of the system class described by the
reference project MeepoEmbedding:

    "A distributed high-performance dynamic lookuptable-style Embedding
     designed for recommendation, search, CTR and advertising systems.
     Supports GPU, CPU, remote distributed KV (such as Redis), SSD, and
     other backends."

Realization (see SURVEY.md §1 for the layer map):

- Hash-keyed, growable/evictable embedding tables stored as flat JAX arrays
  in device memory (bucketized open addressing; one bucket == one 128-lane
  row).
- Lookup / insert / sparse-optimizer update as vectorized XLA programs;
  table writes are XLA scatters into donated, in-place planes.
- Row-sharding across a device mesh via `jax.shard_map` with all-to-all ID
  exchange (XLA collectives, NCCL on GPUs).
- Host-DRAM (C++), remote-KV and disk spill tiers behind one KVBackend
  protocol (the reference's "GPU, CPU, Redis, SSD, and other backends").
- Streaming sharded checkpoints with elastic reshard-on-restore.
"""

__version__ = "0.1.0"

from meepoembedding_tpu.config import (  # noqa: F401
    TableConfig,
    OptimizerConfig,
    PolicyConfig,
    RunConfig,
)
from meepoembedding_tpu.table.runtime import DynamicEmbeddingTable  # noqa: F401

# Heavier surfaces (trainers, TableGroup, serving) import from their modules:
#   from meepoembedding_tpu import embed          # differentiable lookup op
#   from meepoembedding_tpu.train import Trainer
#   from meepoembedding_tpu.group_train import GroupTrainer
#   from meepoembedding_tpu.table.group import TableGroup
#   from meepoembedding_tpu.parallel.trainer import ShardedTrainer
