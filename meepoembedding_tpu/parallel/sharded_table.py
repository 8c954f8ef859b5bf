"""Row-sharded table + all-to-all ID exchange (SURVEY.md C12/C13, §3.2-3.3).

Runs INSIDE `jax.shard_map` over the mesh axis `d`. Each device owns one
TableShard; `owner(key) = hash(key) >> k` routes every id to exactly one
shard. The exchange is the MoE-dispatch communication pattern:

  source side   dedup local batch ids, bucket by owner, place into a
                [S, cap] send buffer (static per-destination capacity —
                data-dependent counts can't size buffers under jit; ids
                beyond cap are dropped and counted, like MoE token drop).
  all_to_all    ids out / rows back / grads back ride the same plan.
  owner side    RE-dedup received ids (the same key can arrive from many
                sources — without this a new key would claim several slots),
                find_or_insert, gather rows once per unique key.

Gradients reverse the exact forward plan and are segment-summed on the owner
before one in-place sparse-optimizer update per key (SURVEY.md §3.3).

The reference class implements this with NCCL all-to-all + CUDA dedup
(BASELINE north-star: row-sharded across hosts, with all-to-all ID
exchange and dedup before lookup).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from meepoembedding_tpu.config import LANES
from meepoembedding_tpu.ops import dedup, optim
from meepoembedding_tpu.table import hashing, xla_ops
from meepoembedding_tpu.table.layout import TableShard, TableSpec
from meepoembedding_tpu.table.xla_ops import _segmented_rank

ROUTE_DROPS = 8  # counters index (extends layout counter names)

# Testing/benchmarking hook: run the full routing + a2a + owner-side
# re-dedup machinery even on a 1-shard mesh (bench_sharded_overhead.py
# uses it to price the exchange without multi-chip hardware).
FORCE_EXCHANGE = False

# bf16 tables ship gradients over the a2a in bf16 (half the wire bytes).
# PARITY NOTE (advisor r3): the quantization happens BEFORE the owner-side
# duplicate segment-sum and the f32 rowwise-adagrad accumulator update, so
# S>1 numerics differ in the last bf16 ulp from the S==1 fast path (which
# keeps f32 grads end-to-end) and from the single-device trainer. The drift
# is bounded by bf16 rounding of individual per-unique grads — tested to
# track the f32 wire within ~1e-2 over 30 steps (tests/test_sharded.py,
# bf16 wire-parity test). Deployments that need bit-comparability between
# 1-chip and S-chip runs set MEEPO_GRAD_WIRE_BF16=0 to spend the bytes.
import os as _os

GRAD_WIRE_BF16 = _os.environ.get("MEEPO_GRAD_WIRE_BF16", "1") != "0"


def a2a_capacity(unique_cap: int, num_shards: int, factor: float = 1.25) -> int:
    """Static per-(src,dst) buffer size. factor >= num_shards is lossless.
    Owner routing is a murmur-mixed hash, so per-destination counts are
    binomial(U, 1/S) — factor 1.25 is tens of sigma of headroom at real
    batch sizes; overflow is counted (ROUTE_DROPS) and the trainer
    auto-doubles the factor if it ever fires."""
    if num_shards == 1:
        return unique_cap
    cap = int(factor * unique_cap / num_shards)
    cap = max(LANES, -(-cap // LANES) * LANES)
    return min(cap, unique_cap)


class RouteCtx(NamedTuple):
    owner: jax.Array  # i32 [U] owning shard of each local unique id
    pos: jax.Array  # i32 [U] position in the owner's send block
    ok: jax.Array  # bool [U] placed within capacity
    lctx: object  # xla_ops.LookupCtx of the owner-side lookup (or slot array
    # for the dim > 128 path) — threads slot/fresh/window state to the update
    inverse: jax.Array  # i32 [S*cap] owner-side dedup inverse
    # owner-side miss info (for async cold-tier promotion, SURVEY.md §3.4):
    # the ids THIS shard received and did not already hold
    miss_hi: jax.Array  # i32 [S*cap]
    miss_lo: jax.Array  # i32 [S*cap]
    miss: jax.Array  # bool [S*cap]


def _route(uh, ul, valid, num_shards: int, cap: int):
    owner = hashing.owner_of(uh, ul, num_shards)
    owner = jnp.where(valid, owner, num_shards)
    order, rank_sorted = _segmented_rank(owner)
    n = uh.shape[0]
    pos = jnp.zeros((n,), jnp.int32).at[order].set(rank_sorted)
    ok = valid & (pos < cap)
    return owner, pos, ok


def _a2a_ids(uh, ul, o, pos, S: int, cap: int, axis: str):
    """Route (hi, lo) id halves to owners in ONE fused all_to_all.

    The two i32 halves ride as the last axis of a single [S, cap, 2] buffer,
    so the exchange pays one collective launch instead of two back-to-back
    [S, cap] transfers. Payload bytes are
    identical; the saving is per-collective overhead, which at production
    cap sizes is the dominant cost of a small-message a2a."""
    send = jnp.stack(
        [
            jnp.full((S, cap), hashing.EMPTY_HI, jnp.int32),
            jnp.full((S, cap), hashing.EMPTY_LO, jnp.int32),
        ],
        axis=-1,
    )
    send = send.at[o, pos].set(jnp.stack([uh, ul], axis=-1), mode="drop")
    recv = lax.all_to_all(send, axis, split_axis=0, concat_axis=0)
    return recv[..., 0].reshape(-1), recv[..., 1].reshape(-1)


def exchange_lookup(
    spec: TableSpec,
    shard: TableShard,
    uh,
    ul,
    valid,
    step,
    axis: str,
    cap: int,
    train: bool = True,
    ragged: bool = False,
    owner_sorted: bool = False,
) -> Tuple[TableShard, jax.Array, RouteCtx]:
    """Sharded find_or_insert + gather for local unique ids.
    Returns (shard', emb_u [U, dim], ctx for the gradient reverse path).

    ragged=True routes the payload over parallel/ragged.py (the wire carries only
    the routed rows; `cap` is then the RECEIVER total = ragged_recv_cap, not
    the dense per-pair capacity). The S==1 fast path is shared."""
    S = lax.axis_size(axis)
    if S == 1 and not FORCE_EXCHANGE:
        # single-shard mesh: every id is locally owned and already deduped —
        # skip routing, the a2a (XLA would lower it to copies, but the
        # send-buffer scatter, owner re-dedup sort, and emb re-gather are
        # real work), and run exactly the fused single-device hot path. This
        # keeps a 1-chip deployment of the distributed trainer at the fused
        # step's speed (bench_sharded_overhead.py measures both variants).
        n = uh.shape[0]
        ar = jnp.arange(n, dtype=jnp.int32)
        zero = jnp.zeros((n,), jnp.int32)
        if train and spec.dim <= 128:
            shard, lctx = xla_ops.lookup_train(spec, shard, uh, ul, valid, step)
            found = lctx.found
            emb_u = xla_ops.window_extract(spec, lctx.g128, lctx.sub).astype(spec.dtype)
        elif train:
            shard, slot, found = xla_ops.find_or_insert(
                spec, shard, uh, ul, valid, step
            )
            lctx = slot
            emb_u = xla_ops.lookup_rows(spec, shard, slot).astype(spec.dtype)
        else:
            pr = xla_ops.probe(spec, shard, uh, ul, valid)
            slot = jnp.where(pr.found, pr.slot, -1)
            found = pr.found
            lctx = slot
            emb_u = xla_ops.lookup_rows(spec, shard, slot).astype(spec.dtype)
        return shard, emb_u, RouteCtx(
            owner=zero, pos=ar, ok=valid, lctx=lctx, inverse=ar,
            miss_hi=uh, miss_lo=ul, miss=valid & ~found,
        )
    if ragged:
        from meepoembedding_tpu.parallel import ragged as rg

        return rg.exchange_lookup(
            spec, shard, uh, ul, valid, step, axis, cap, train=train,
            owner_sorted=owner_sorted,
        )
    owner, pos, ok = _route(uh, ul, valid, S, cap)

    o = jnp.where(ok, owner, S)
    rhi, rlo = _a2a_ids(uh, ul, o, pos, S, cap, axis)
    runiq = dedup.unique_pairs(rhi, rlo, size=rhi.shape[0])
    if train and spec.dim <= 128:
        # fused window-space owner-side lookup (xla_ops.lookup_train): rows
        # stay at 128 lanes through the dedup-inverse expansion; the [.., dim]
        # view only materializes for the a2a payload (wire volume stays dim)
        shard, lctx = xla_ops.lookup_train(
            spec, shard, runiq.hi, runiq.lo, runiq.valid, step
        )
        found = lctx.found
        rows = xla_ops.rows_for_batch(
            spec, lctx.g128, lctx.sub, runiq.inverse
        ).astype(spec.dtype).reshape(S, cap, spec.dim)
    elif train:
        shard, slot, found = xla_ops.find_or_insert(
            spec, shard, runiq.hi, runiq.lo, runiq.valid, step
        )
        lctx = slot
        rows_u = xla_ops.lookup_rows(spec, shard, slot)  # [S*cap, dim]
        rows = rows_u[runiq.inverse].reshape(S, cap, spec.dim)
    else:
        pr = xla_ops.probe(spec, shard, runiq.hi, runiq.lo, runiq.valid)
        slot = jnp.where(pr.found, pr.slot, -1)
        found = pr.found
        lctx = slot
        rows = xla_ops.lookup_rows_expand(
            spec, shard, slot, runiq.inverse
        ).reshape(S, cap, spec.dim)

    back = lax.all_to_all(rows, axis, split_axis=0, concat_axis=0)  # [S, cap, dim]
    emb_u = back[jnp.clip(owner, 0, S - 1), jnp.clip(pos, 0, cap - 1)]
    emb_u = jnp.where(ok[:, None], emb_u, 0)

    n_drop = jnp.sum(valid & ~ok).astype(jnp.int32)
    shard = shard._replace(counters=shard.counters.at[ROUTE_DROPS].add(n_drop))
    return shard, emb_u, RouteCtx(
        owner=owner, pos=pos, ok=ok, lctx=lctx, inverse=runiq.inverse,
        miss_hi=runiq.hi, miss_lo=runiq.lo, miss=runiq.valid & ~found,
    )


def exchange_apply_grads(
    spec: TableSpec, shard: TableShard, ctx: RouteCtx, g_u, axis: str, cap: int,
    g2_mean=None,
) -> TableShard:
    """Reverse path: route per-unique grads to owners, segment-sum per key,
    one in-place optimizer update (SURVEY.md §3.3). `g2_mean` threads to
    optim.apply_sparse_grads_ctx (column-sharded rowwise accumulator).
    Dispatches on the ctx type: a RaggedCtx (from the ragged forward) rides
    the ragged return path."""
    from meepoembedding_tpu.parallel import ragged as rg

    if isinstance(ctx, rg.RaggedCtx):
        return rg.exchange_apply_grads(
            spec, shard, ctx, g_u, axis, cap, g2_mean=g2_mean
        )
    S = lax.axis_size(axis)
    if S == 1 and not FORCE_EXCHANGE:
        # single-shard fast path (see exchange_lookup): g_u is already
        # per-unique and locally owned — no a2a, no owner-side segment-sum
        if spec.dim <= 128 and not isinstance(ctx.lctx, jax.Array):
            g_win = xla_ops.window_place(
                spec, g_u.astype(jnp.float32), ctx.lctx.sub
            )
            return optim.apply_sparse_grads_ctx(
                spec, shard, ctx.lctx, g_win, g2_mean=g2_mean
            )
        return optim.apply_sparse_grads(
            spec, shard, ctx.lctx, g_u.astype(jnp.float32)
        )
    o = jnp.where(ctx.ok, ctx.owner, S)
    # Gradients ride the wire in the TABLE dtype: a bf16 table's update math
    # quantizes to bf16 on write anyway, so shipping f32 grads would spend
    # 2x the wire bytes to carry precision the row can't hold. The owner-side
    # segment-sum still runs in f32 (cast right after the a2a) so duplicate
    # contributions accumulate at full precision. See GRAD_WIRE_BF16 above
    # for the S==1-vs-S>1 parity implications and the opt-out.
    wire_dtype = (
        spec.dtype
        if spec.dtype == jnp.bfloat16 and GRAD_WIRE_BF16
        else jnp.float32
    )
    send_g = (
        jnp.zeros((S, cap, spec.dim), wire_dtype)
        .at[o, ctx.pos]
        .set(g_u.astype(wire_dtype), mode="drop")
    )
    recv_g = (
        lax.all_to_all(send_g, axis, split_axis=0, concat_axis=0)
        .reshape(-1, spec.dim)
        .astype(jnp.float32)
    )
    if spec.dim <= 128 and not isinstance(ctx.lctx, jax.Array):
        # window-space owner-side update (see xla_ops hot-path note)
        lctx = ctx.lctx
        g_win = xla_ops.grads_to_window(
            spec, recv_g, lctx.sub, ctx.inverse, lctx.slot.shape[0]
        )
        return optim.apply_sparse_grads_ctx(spec, shard, lctx, g_win, g2_mean=g2_mean)
    slot = ctx.lctx
    g_per_key = dedup.segment_sum_grads(recv_g, ctx.inverse, num_unique=slot.shape[0])
    return optim.apply_sparse_grads(spec, shard, slot, g_per_key)


def exchange_erase(
    spec: TableSpec, shard: TableShard, uh, ul, valid, axis: str, cap: int
) -> Tuple[TableShard, jax.Array]:
    """Distributed explicit removal (runtime.remove's sharded analog): route
    ids to their owner shards over the same a2a, dedup owner-side (the input
    may be REPLICATED across devices — each owner receives S copies and the
    dedup collapses them), erase found slots. Returns (shard', removed) with
    `removed` the GLOBAL count (psum; each key is erased on exactly one
    owner, so the sum is exact)."""
    S = lax.axis_size(axis)
    if S == 1 and not FORCE_EXCHANGE:
        # single shard: just dedup locally (callers may pass duplicate sets;
        # invalid/EMPTY entries come out of the dedup marked invalid)
        runiq = dedup.unique_pairs(uh, ul, size=uh.shape[0])
        shard, found = xla_ops.erase_keys(
            spec, shard, runiq.hi, runiq.lo, runiq.valid
        )
        return shard, jnp.sum(found).astype(jnp.int32)
    owner, pos, ok = _route(uh, ul, valid, S, cap)
    o = jnp.where(ok, owner, S)
    rhi, rlo = _a2a_ids(uh, ul, o, pos, S, cap, axis)
    runiq = dedup.unique_pairs(rhi, rlo, size=rhi.shape[0])
    shard, found = xla_ops.erase_keys(spec, shard, runiq.hi, runiq.lo, runiq.valid)
    removed = lax.psum(jnp.sum(found).astype(jnp.int32), axis)
    n_drop = jnp.sum(valid & ~ok).astype(jnp.int32)
    shard = shard._replace(counters=shard.counters.at[ROUTE_DROPS].add(n_drop))
    return shard, removed


# --- stacked-shard helpers (shard_map passes [1, ...] leaves) ----------------

def squeeze_shard(stacked: TableShard) -> TableShard:
    return jax.tree.map(lambda a: a[0], stacked)


def unsqueeze_shard(shard: TableShard) -> TableShard:
    return jax.tree.map(lambda a: a[None], shard)
