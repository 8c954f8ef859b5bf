"""Device-memory hash-table layout (SURVEY.md C1).

A shard of a dynamic table is a set of flat JAX arrays whose last dim is
always 128 (no padding in (8, 128)-tiled layouts):

  bucket geometry   one bucket == one 128-lane row; probing a bucket is a
                    single vector compare. `nb` buckets (power of two) give
                    `nb * 128` slots per shard.
  key planes        key_hi/key_lo int32 [nb, 128]; empty slot == sentinel.
  metadata planes   freq (hit count) / last (last-touched step) int32
                    [nb, 128]; cnt/ovf int32 [nb] (bucket fill + sticky
                    "ever overflowed" flag that keeps probe chains sound
                    after eviction holes appear).
  value storage     values float [vrows, 128]. For dim <= 128 each storage
                    row packs `pack = 128 // dim` logical rows, so slot s
                    lives at (s // pack, (s %% pack) * dim). For dim >= 128
                    each slot spans dim // 128 consecutive storage rows.
  optimizer slots   rowwise planes shaped like the key planes ([nb, 128],
                    one scalar per row); full-dim planes shaped like values.
  counters          int64-free int32 [16] event counters (SURVEY.md C22).
  cms               count-min sketch int32 [4, W] for frequency admission
                    (SURVEY.md C10); empty when admission is disabled.

The reference class keeps this structure in CUDA device memory behind a
native hash table (README.md:2 "high-performance dynamic lookuptable-style
Embedding"); here it is plain sharded JAX arrays so XLA/GSPMD can partition,
donate and fuse around it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meepoembedding_tpu.config import LANES, OptimizerConfig, PolicyConfig, TableConfig
from meepoembedding_tpu.table import hashing

# counters indices (SURVEY.md C22); 8 is ROUTE_DROPS (parallel/sharded_table)
HITS, MISSES, INSERTS, DROPS, EVICTIONS, SPILLS, PROMOTES, DENIED = range(8)
ERASES = 9  # explicit key removals (xla_ops.erase_keys / runtime.remove)
NUM_COUNTERS = 16


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static (hashable) geometry of one table shard. Passed as a static
    argument to jitted table ops; the arrays themselves live in TableShard."""

    dim: int
    num_buckets: int  # power of two
    initializer_scale: float
    max_probe_rounds: int
    value_dtype: str
    optimizer: OptimizerConfig
    policy: PolicyConfig
    insert_cap: "int | None" = None
    # fresh-row initializer kind (hashing.INITIALIZERS)
    initializer: str = "uniform"
    # column sharding (parallel/colsharded.py): this shard holds lanes
    # [off, off + dim) of a wider logical row, where off = init_lane_offset
    # (+ axis_index(init_lane_axis) * dim under shard_map — SPMD traces one
    # program, so the per-column offset must come from the mesh axis). The
    # fresh-row initializer reproduces exactly those lanes' bits.
    init_lane_offset: int = 0
    init_lane_axis: "str | None" = None

    def lane_offset(self):
        """Initializer lane offset (static int or traced under shard_map)."""
        off = self.init_lane_offset
        if self.init_lane_axis is not None:
            off = off + jax.lax.axis_index(self.init_lane_axis) * self.dim
        return off

    @staticmethod
    def from_config(cfg: TableConfig, num_shards: int = 1) -> "TableSpec":
        return TableSpec(
            dim=cfg.dim,
            num_buckets=cfg.buckets_per_shard(num_shards),
            initializer_scale=cfg.initializer_scale,
            initializer=cfg.initializer,
            max_probe_rounds=cfg.max_probe_rounds,
            value_dtype=cfg.value_dtype,
            optimizer=cfg.optimizer,
            policy=cfg.policy,
            insert_cap=cfg.insert_cap,
        )

    # --- derived geometry -------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.num_buckets * LANES

    @property
    def pack(self) -> int:
        """Logical rows per 128-lane value-storage row (dim <= 128)."""
        return max(1, LANES // self.dim)

    @property
    def rows_per_slot(self) -> int:
        """Value-storage rows per logical row (dim >= 128)."""
        return max(1, self.dim // LANES)

    @property
    def value_rows(self) -> int:
        return self.capacity * self.rows_per_slot // self.pack

    @property
    def dtype(self):
        return jnp.dtype(self.value_dtype)

    def hbm_bytes(self) -> int:
        itemsize = self.dtype.itemsize
        n_full = self.optimizer.num_fulldim_slots()
        n_row = self.optimizer.num_rowwise_slots()
        values = self.value_rows * LANES * itemsize * (1 + n_full)
        keys_meta = self.num_buckets * LANES * 4 * (4 + n_row)
        return values + keys_meta


class TableShard(NamedTuple):
    """All device state of one table shard (a pytree of arrays only)."""

    key_hi: jax.Array  # i32 [nb, 128]
    key_lo: jax.Array  # i32 [nb, 128]
    cnt: jax.Array  # i32 [nb]   live rows per bucket
    ovf: jax.Array  # i32 [nb]   sticky overflow flag (probe-chain soundness)
    freq: jax.Array  # i32 [nb, 128]
    last: jax.Array  # i32 [nb, 128]
    values: jax.Array  # f32/bf16 [vrows, 128]
    opt_rowwise: Tuple[jax.Array, ...]  # each f32 [nb, 128]
    opt_fulldim: Tuple[jax.Array, ...]  # each like values
    counters: jax.Array  # i32 [16]
    cms: jax.Array  # i32 [4, W] (W == 0 when admission disabled)


def alloc_shard(spec: TableSpec) -> TableShard:
    """Allocate an empty shard (host-side; call under jit/device_put for HBM).

    INVARIANT: free slots hold ZERO in values, optimizer planes, freq and
    last. Insert then writes initial state as an exact ADD over zero, and
    eviction restores zero by subtracting the exported state — this keeps
    every hot-path table write on XLA's fast duplicate-tolerant row
    scatter-ADD (SET scatters need an expensive combine pass)."""
    nb = spec.num_buckets
    kshape = (nb, LANES)
    rowwise = tuple(
        jnp.zeros(kshape, jnp.float32)
        for _ in range(spec.optimizer.num_rowwise_slots())
    )
    fulldim = tuple(
        jnp.zeros((spec.value_rows, LANES), spec.dtype)
        for _ in range(spec.optimizer.num_fulldim_slots())
    )
    cms_w = spec.policy.cms_width if spec.policy.admit_threshold > 1 else 0
    return TableShard(
        key_hi=jnp.full(kshape, hashing.EMPTY_HI, jnp.int32),
        key_lo=jnp.full(kshape, hashing.EMPTY_LO, jnp.int32),
        cnt=jnp.zeros((nb,), jnp.int32),
        ovf=jnp.zeros((nb,), jnp.int32),
        freq=jnp.zeros(kshape, jnp.int32),
        last=jnp.zeros(kshape, jnp.int32),
        values=jnp.zeros((spec.value_rows, LANES), spec.dtype),
        opt_rowwise=rowwise,
        opt_fulldim=fulldim,
        counters=jnp.zeros((NUM_COUNTERS,), jnp.int32),
        cms=jnp.zeros((4, cms_w), jnp.int32),
    )


# --- slot <-> storage geometry (dim <= 128 packed path) ---------------------

def slot_to_bucket_lane(slot):
    return slot // LANES, slot % LANES


def slot_to_vrow_sub(spec: TableSpec, slot):
    """Value-storage coordinates of a slot (dim <= 128)."""
    return slot // spec.pack, slot % spec.pack


def load_factor(spec: TableSpec, shard: TableShard) -> jax.Array:
    return jnp.sum(shard.cnt).astype(jnp.float32) / float(spec.capacity)


def live_mask(shard: TableShard) -> jax.Array:
    """[nb, 128] bool: slot holds a live row."""
    return ~((shard.key_hi == hashing.EMPTY_HI) & (shard.key_lo == hashing.EMPTY_LO))
