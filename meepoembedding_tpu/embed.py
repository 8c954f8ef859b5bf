"""Public differentiable embedding-lookup op (SURVEY.md L4 / §3.2-3.3).

The reference class exposes embedding lookup as a framework op with a custom
gradient so users can drop a dynamic table into ANY model (SURVEY.md L4:
"embedding_lookup(table, ids) with custom gradient"; the reference's own
surface is the TFRA-`dynamic_embedding` lineage). The built-in trainers
(`train.Trainer`, `parallel.trainer.ShardedTrainer`, `group_train.GroupTrainer`)
fuse this path into their jitted steps for the model zoo; this module is the
same hot path as a STANDALONE, jit-composable pair for bring-your-own-model
users:

    from meepoembedding_tpu import embed

    @partial(jax.jit, donate_argnums=(0,))
    def my_step(shard, params, hi, lo, step):
        shard, ectx, emb = embed.lookup(spec, shard, hi, lo, step)
        loss, (g_params, g_emb) = jax.value_and_grad(my_loss, (0, 1))(params, emb)
        shard = embed.update(spec, shard, ectx, g_emb)   # in-place sparse opt
        ...dense optimizer on g_params...
        return shard, params, loss

Semantics match the fused trainers exactly:

- `lookup` dedups the batch (one multi-operand sort), probes/inserts once per
  UNIQUE id, and returns batch-order rows via U-level window transforms.
  Fresh ids' rows come from the deterministic initializer without touching
  the values plane (the init folds into `update`'s single scatter pass).
- `emb` is an ordinary differentiable array: `jax.grad` through it produces
  per-occurrence grads, and `update` segment-sums duplicates and applies the
  configured sparse optimizer (SGD / rowwise-AdaGrad fused; AdaGrad / Adam /
  FTRL / momentum via the generic path) in one donated pass over the table.
- Invalid ids (the EMPTY sentinel, e.g. bag padding) read zero rows and
  receive no update.

In functional JAX the table is explicit state: `lookup`/`update` thread the
`TableShard` pytree instead of mutating a hidden variable, which is what lets
XLA donate the buffers and keep 100M+-row tables single-copy in HBM.

For a row-sharded table under `shard_map`, compose
`parallel.sharded_table.exchange_lookup` / `exchange_apply_grads` — the same
phases with a drop-free all-to-all owner exchange between them (see
`parallel.trainer.ShardedTrainer._build_step` for the canonical wiring).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from meepoembedding_tpu.ops import dedup, optim
from meepoembedding_tpu.table import xla_ops
from meepoembedding_tpu.table.layout import TableShard, TableSpec


class EmbedCtx(NamedTuple):
    """Lookup context threaded from `lookup` to `update` (one batch)."""

    slot: jax.Array  # i32 [U]; -1 == denied/dropped
    found: jax.Array  # bool [U]
    fresh: jax.Array  # bool [U] inserted this step
    g128: jax.Array  # [U, 128] window-space rows (dim<=128) or [U, dim]
    sub: jax.Array  # i32 [U] lane-window index (dim<=128)
    inverse: jax.Array  # i32 [n] batch position -> unique index
    count: jax.Array  # i32 [] number of uniques

    @property
    def lookup_ctx(self) -> xla_ops.LookupCtx:
        return xla_ops.LookupCtx(self.slot, self.found, self.fresh,
                                 self.g128, self.sub)


def lookup(
    spec: TableSpec,
    shard: TableShard,
    hi: jax.Array,
    lo: jax.Array,
    step,
    *,
    unique_cap: Optional[int] = None,
    train: bool = True,
) -> Tuple[TableShard, EmbedCtx, jax.Array]:
    """Dedup'd find-or-insert lookup. -> (shard, ctx, emb).

    hi/lo: i32 id halves (`table.hashing.split_ids`), any shape; `emb` comes
    back as `hi.shape + (dim,)`, always float32 (for a bf16 table the rows
    are widened — one documented dtype across every dim regime).

    `unique_cap` bounds the dedup output size (static; default = batch size,
    which is always lossless). WARNING: a cap SMALLER than the true unique
    count silently aliases the overflow ids onto the last dedup slot — they
    read each other's rows and their grads mix (dedup.unique_pairs). Only
    pass a smaller cap when the stream's unique count is genuinely bounded;
    `ctx.count == cap` after the fact means the cap was hit.

    CONTRACT: a `train=True` lookup must be paired with exactly one `update`
    for the same ctx before the next lookup — zero grads are fine. The
    mechanism differs by dim regime:
    - dim <= 128 (window path): `lookup` registers fresh keys in the side
      planes but leaves their VALUES rows zero; the initializer values land
      in `update`'s single scatter pass (one values-plane write per step).
      `emb` itself
      already carries the correct initializer rows. An UNPAIRED train
      lookup therefore leaves fresh keys registered with zero value rows —
      the next lookup returns zeros for them, not the initializer. Use
      `train=False` for lookups that will never be paired with an update.
    - dim > 128: `find_or_insert` materializes initializer rows during
      lookup; an unpaired lookup leaves the initializer values (benign).
    """
    batch_shape = hi.shape
    hi_f, lo_f = hi.reshape(-1), lo.reshape(-1)
    cap = int(unique_cap or hi_f.shape[0])
    uniq = dedup.unique_pairs(hi_f, lo_f, cap)
    step = jnp.asarray(step, jnp.int32)

    if not train:
        pr = xla_ops.probe(spec, shard, uniq.hi, uniq.lo, uniq.valid)
        slot = jnp.where(pr.found, pr.slot, -1)
        fresh = jnp.zeros_like(pr.found)
        if spec.dim <= 128:
            g128, sub = xla_ops.lookup_rows128(spec, shard, slot)
            ctx = EmbedCtx(slot, pr.found, fresh, g128, sub,
                           uniq.inverse, uniq.count)
            emb = xla_ops.rows_for_batch(spec, g128, sub, uniq.inverse)
        else:
            rows_u = xla_ops.lookup_rows(spec, shard, slot)
            sub = jnp.zeros_like(slot)
            ctx = EmbedCtx(slot, pr.found, fresh, rows_u, sub,
                           uniq.inverse, uniq.count)
            # single public dtype: f32 in every dim regime (ADVICE r2)
            emb = rows_u[uniq.inverse].astype(jnp.float32)
        return shard, ctx, emb.reshape(*batch_shape, spec.dim)

    if spec.dim <= 128:
        shard, lctx = xla_ops.lookup_train(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step
        )
        ctx = EmbedCtx(lctx.slot, lctx.found, lctx.fresh, lctx.g128, lctx.sub,
                       uniq.inverse, uniq.count)
        emb = xla_ops.rows_for_batch(spec, lctx.g128, lctx.sub, uniq.inverse)
    else:
        shard, slot, found = xla_ops.find_or_insert(
            spec, shard, uniq.hi, uniq.lo, uniq.valid, step
        )
        rows_u = xla_ops.lookup_rows(spec, shard, slot)
        fresh = uniq.valid & ~found & (slot >= 0)
        ctx = EmbedCtx(slot, found, fresh, rows_u, jnp.zeros_like(slot),
                       uniq.inverse, uniq.count)
        # single public dtype: f32 in every dim regime (ADVICE r2)
        emb = rows_u[uniq.inverse].astype(jnp.float32)
    return shard, ctx, emb.reshape(*batch_shape, spec.dim)


def update(
    spec: TableSpec, shard: TableShard, ctx: EmbedCtx, grads: jax.Array
) -> TableShard:
    """Apply batch-order grads ([*batch, dim], e.g. `jax.grad` w.r.t. `emb`)
    through the configured sparse optimizer. Duplicates segment-sum; fresh
    rows receive initializer + first update in the same scatter pass."""
    g = grads.reshape(-1, spec.dim)
    num_unique = ctx.g128.shape[0]
    if spec.dim <= 128:
        g_win = xla_ops.grads_to_window(spec, g, ctx.sub, ctx.inverse, num_unique)
        return optim.apply_sparse_grads_ctx(spec, shard, ctx.lookup_ctx, g_win)
    g_u = dedup.segment_sum_grads(g, ctx.inverse, num_unique)
    return optim.apply_sparse_grads(spec, shard, ctx.slot, g_u)


def update_window(
    spec: TableSpec, shard: TableShard, ctx: EmbedCtx, g_win: jax.Array
) -> TableShard:
    """Advanced variant: window-space [U, 128] grads (dim<=128), e.g. from
    differentiating a loss w.r.t. `ctx.g128` through `xla_ops.rows_for_batch`
    — the built-in trainers' formulation, which keeps the backward entirely
    at 128 lanes."""
    assert spec.dim <= 128
    return optim.apply_sparse_grads_ctx(spec, shard, ctx.lookup_ctx, g_win)
