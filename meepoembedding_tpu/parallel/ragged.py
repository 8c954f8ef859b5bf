"""Ragged all-to-all ID/row/grad exchange (SURVEY.md C13, §3.2-3.3).

The dense exchange (`sharded_table.py`) ships fixed `[S, cap]` buffers per
direction: the interconnect carries `factor * U` rows regardless of how many
ids actually routed anywhere (the padding IS the drop-freedom). This module
is the ragged variant the blueprint names (SURVEY.md C13): the send buffer
is the owner-sorted compaction of the local uniques, per-pair counts ride a
tiny `[S, 2]` all_gather, and the payload collective is
`lax.ragged_all_to_all` — the wire carries exactly the routed rows.

What changes vs dense, concretely:
  payload volume   `sum(send_sizes)` <= U rows per direction instead of
                   `factor * U` — the `factor - 1` padding never leaves the
                   chip, and imbalance costs bytes only where it exists.
  drop model       dense drops when ONE (src, dst) pair exceeds `cap =
                   factor*U/S` (binomial per pair); ragged drops only when a
                   RECEIVER's total inflow exceeds `rcap = factor*U` — the
                   sum of S binomials, concentration tighter by ~sqrt(S).
                   Same ROUTE_DROPS counter, same trainer auto-resize.
  owner compute    identical: the owner re-dedups/looks up over `rcap` slots
                   vs the dense `S*cap = factor*U` — same size.

Transport: on every backend the plan runs over a dense-emulated transport
that is element-exact to the ragged collective's write semantics, so every
plan/clamp/inverse test on the 8-vdev CPU mesh covers the production path.
XLA:CPU cannot lower `ragged-all-to-all` ("HLO opcode `ragged-all-to-all` is
not supported by XLA:CPU ThunkEmitter"). XLA:GPU lowers it, but on four H100s
the sharded step over it lost ids that the same step over the emulation kept
(ROADMAP B9): its one-shot kernel is at fault, since with
`--xla_gpu_unsupported_use_ragged_all_to_all_one_shot_kernel=false` the
collective matched. `EMULATE_TRANSPORT = False` selects the collective.
The emulation ships S*U rows per direction, so the payload saving above
waits on B9; the drop model and owner compute hold as described.

The reference class implements this as NCCL ragged/grouped all-to-all
(BASELINE north-star: "all-to-all ID exchange and dedup before lookup").
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

# True: the emulated transport (every backend until ROADMAP B9 is fixed);
# False: `lax.ragged_all_to_all`. Read when a step is traced.
EMULATE_TRANSPORT = True


def ragged_recv_cap(unique_cap: int, num_shards: int, factor: float = 1.25) -> int:
    """Static receiver-side buffer rows. Expected inflow is ~unique_cap
    (each of S sources routes ~U/S ids here); factor is headroom against
    hash imbalance — overflow is clamped sender-side, counted (ROUTE_DROPS)
    and auto-resized by the trainer exactly like the dense capacity."""
    cap = int(factor * unique_cap)
    cap = max(LANES, -(-cap // LANES) * LANES)
    return min(cap, num_shards * unique_cap)


class RaggedPlan(NamedTuple):
    """One routing round's complete exchange geometry (all [S] i32 unless
    noted). Built once per step by `make_plan`; both payload directions and
    the gradient return ride it."""

    order: jax.Array  # i32 [U] owner-sort permutation (invalid ids last)
    sendpos: jax.Array  # i32 [U] position of unique i in the sorted buffer
    ok: jax.Array  # bool [U] id survived the receiver clamp
    in_off: jax.Array  # my outgoing segment starts (owner-sorted layout)
    send: jax.Array  # CLAMPED per-destination send counts
    out_off: jax.Array  # where my chunk to dst j lands in j's recv buffer
    recv: jax.Array  # CLAMPED per-source receive counts
    recv_off: jax.Array  # my receive layout: source j's chunk starts here
    rev_out_off: jax.Array  # source j's segment start (reverse-path target)
    n_drop: jax.Array  # i32 [] ids beyond the receiver clamp (counted once)


def make_plan(uh, ul, valid, S: int, rcap: int, axis: str,
              owner_sorted: bool = False) -> RaggedPlan:
    """Build the routing geometry and negotiate clamped counts/offsets.

    `owner_sorted=True` declares the uniques ALREADY owner-grouped ascending
    with invalid ids last — what `dedup.unique_pairs(owner_major=S)` emits —
    and skips the [U] owner argsort entirely: the step's one dedup sort does
    double duty as the send-buffer compaction (VERDICT r4 next-#8).

    The negotiation is ONE [S, 2] all_gather (was: two DEPENDENT [S, 2]
    all_to_alls — a serial 2-round latency chain). Gathering every device's
    (per-destination count, segment start) hands each device the full
    [S_src, S_dst] count matrix, from which BOTH sides of the clamp derive
    locally: my inflow clamp (column me), every receiver's clamp of MY
    segments (my row vs the column prefix sums), and the reverse-path write
    offsets (the gathered segment starts). Same bytes on the wire, half the
    rounds."""
    n = uh.shape[0]
    owner = hashing.owner_of(uh, ul, S)
    owner = jnp.where(valid, owner, S)
    idx = jnp.arange(n, dtype=jnp.int32)
    if owner_sorted:
        order = idx
        sendpos = idx
        ks = owner  # already owner-grouped ascending, invalids last
    else:
        order, rank_sorted = _segmented_rank(owner)
        sendpos = jnp.zeros((n,), jnp.int32).at[order].set(idx)
        ks = jnp.take(owner, order)
    # Segment geometry straight from the sorted owners: S+1 binary searches,
    # no [n]-sized scatter/bincount.
    bounds = jnp.searchsorted(
        ks, jnp.arange(S + 1, dtype=ks.dtype), side="left"
    ).astype(jnp.int32)
    in_off = bounds[:-1]
    send_want = bounds[1:] - bounds[:-1]
    # rank of each unique within its owner segment (positions are owner-
    # sorted, so rank = sorted position - segment start)
    rank_sorted2 = idx - jnp.take(in_off, jnp.clip(ks, 0, S - 1))
    rank = (
        rank_sorted2 if owner_sorted
        else jnp.zeros((n,), jnp.int32).at[order].set(rank_sorted2)
    )

    # one-round negotiation: everyone's (counts row, segment starts row)
    g = lax.all_gather(
        jnp.stack([send_want, in_off], axis=-1), axis
    )  # [S_src, S_dst, 2]
    C = g[:, :, 0]  # C[src, dst]: rows src wants to send dst
    me = lax.axis_index(axis)
    # column-wise exclusive prefix over sources = each receiver's clamp state
    cum_all = jnp.concatenate(
        [jnp.zeros((1, S), jnp.int32), jnp.cumsum(C, axis=0)[:-1]], axis=0
    )
    # my inflow (receiver side): column `me`
    recv_want = C[:, me]
    cum = cum_all[:, me]
    recv_off = jnp.minimum(cum, rcap)
    recv = jnp.clip(rcap - cum, 0, recv_want)
    # my outflow (sender side): row `me` against every column's prefix
    mine = jnp.take(cum_all, me, axis=0)  # [S_dst] rows ahead of my segment
    send = jnp.clip(rcap - mine, 0, jnp.take(C, me, axis=0))
    out_off = jnp.minimum(mine, rcap)
    # where my returning rows land at each source: its segment start for me
    rev_out_off = g[:, :, 1][:, me]

    ok = valid & (rank < jnp.take(send, jnp.clip(owner, 0, S - 1)))
    n_drop = jnp.sum(valid & ~ok).astype(jnp.int32)
    return RaggedPlan(
        order=order, sendpos=sendpos, ok=ok, in_off=in_off, send=send,
        out_off=out_off, recv=recv, recv_off=recv_off,
        rev_out_off=rev_out_off, n_drop=n_drop,
    )


def _transport(operand, output, in_off, send, out_off, recv, axis: str):
    """One ragged payload exchange: an element-exact emulation over a dense
    all_to_all (pad each outgoing segment to the operand length, compact at
    the receive offsets), or the real `lax.ragged_all_to_all`.
    Non-received output positions keep `output`'s prefill in BOTH paths."""
    if not EMULATE_TRANSPORT:
        return lax.ragged_all_to_all(
            operand, output, in_off, send, out_off, recv, axis_name=axis
        )
    S = in_off.shape[0]
    n = operand.shape[0]
    k = jnp.arange(n, dtype=jnp.int32)
    idx = jnp.clip(in_off[:, None] + k[None, :], 0, n - 1)  # [S, n]
    seg = jnp.take(operand, idx, axis=0)  # [S, n, ...]
    mask = k[None, :] < send[:, None]
    seg = jnp.where(mask.reshape(mask.shape + (1,) * (operand.ndim - 1)), seg, 0)
    rec = lax.all_to_all(seg, axis, 0, 0)  # [S, n, ...] one row per source
    # The receiver's local start for source j's chunk is what j was told as
    # its remote write offset — exchange out_off so each side learns its own
    # receive layout (the real collective's writes are offset-addressed; the
    # reverse direction lands chunks at the ORIGINAL segment starts, with
    # gaps where the clamp dropped tails, so cumsum(recv) would be wrong).
    local_off = lax.all_to_all(out_off.reshape(S, 1), axis, 0, 0).reshape(-1)
    m = output.shape[0]
    p = jnp.arange(m, dtype=jnp.int32)
    # source of output position p: last chunk starting at or before p whose
    # extent covers it. Plans always lay chunks out in source order with
    # non-decreasing offsets; empty chunks share an offset, so search chunk
    # ENDS (first end > p), not starts.
    end = (local_off + recv).astype(jnp.int32)
    j = jnp.clip(jnp.searchsorted(end, p, side="right"), 0, S - 1)
    kk = p - jnp.take(local_off, j)
    valid = (kk >= 0) & (kk < jnp.take(recv, j))
    got = rec[j, jnp.clip(kk, 0, n - 1)]
    return jnp.where(
        valid.reshape(valid.shape + (1,) * (operand.ndim - 1)), got, output
    )


class RaggedCtx(NamedTuple):
    """Threads the forward plan + owner-side lookup state to the gradient
    return (the ragged analog of sharded_table.RouteCtx)."""

    plan: RaggedPlan
    lctx: object  # xla_ops.LookupCtx (dim<=128 train) or slot array
    inverse: jax.Array  # i32 [rcap] owner-side dedup inverse
    miss_hi: jax.Array
    miss_lo: jax.Array
    miss: jax.Array
    owner_sorted: bool = False  # uniques pre-sorted by owner (no permute)


def exchange_lookup(
    spec: TableSpec,
    shard: TableShard,
    uh,
    ul,
    valid,
    step,
    axis: str,
    rcap: int,
    train: bool = True,
    owner_sorted: bool = False,
) -> Tuple[TableShard, jax.Array, RaggedCtx]:
    """Ragged sharded find_or_insert + gather for local unique ids.
    Mirrors sharded_table.exchange_lookup but ships only routed rows.
    owner_sorted=True: the uniques came from unique_pairs(owner_major=S),
    so the send buffer needs no permutation (see make_plan)."""
    from meepoembedding_tpu.parallel import sharded_table as st

    S = lax.axis_size(axis)
    plan = make_plan(uh, ul, valid, S, rcap, axis, owner_sorted=owner_sorted)

    ids2 = jnp.stack([uh, ul], axis=-1)  # [U, 2]
    ids_sorted = ids2 if owner_sorted else ids2[plan.order]
    rbuf = jnp.stack(
        [
            jnp.full((rcap,), hashing.EMPTY_HI, jnp.int32),
            jnp.full((rcap,), hashing.EMPTY_LO, jnp.int32),
        ],
        axis=-1,
    )
    rbuf = _transport(
        ids_sorted, rbuf, plan.in_off, plan.send, plan.out_off, plan.recv, axis
    )
    rhi, rlo = rbuf[:, 0], rbuf[:, 1]
    runiq = dedup.unique_pairs(rhi, rlo, size=rcap)

    if train and spec.dim <= 128:
        shard, lctx = xla_ops.lookup_train(
            spec, shard, runiq.hi, runiq.lo, runiq.valid, step
        )
        found = lctx.found
        rows = xla_ops.rows_for_batch(
            spec, lctx.g128, lctx.sub, runiq.inverse
        ).astype(spec.dtype)  # [rcap, dim]
    elif train:
        shard, slot, found = xla_ops.find_or_insert(
            spec, shard, runiq.hi, runiq.lo, runiq.valid, step
        )
        lctx = slot
        rows = xla_ops.lookup_rows(spec, shard, slot)[runiq.inverse].astype(spec.dtype)
    else:
        pr = xla_ops.probe(spec, shard, runiq.hi, runiq.lo, runiq.valid)
        slot = jnp.where(pr.found, pr.slot, -1)
        found = pr.found
        lctx = slot
        rows = xla_ops.lookup_rows_expand(spec, shard, slot, runiq.inverse)

    # rows back: reverse every leg of the plan
    back = jnp.zeros((uh.shape[0], spec.dim), rows.dtype)
    back = _transport(
        rows, back, plan.recv_off, plan.recv, plan.rev_out_off, plan.send, axis
    )
    back_u = back if owner_sorted else back[plan.sendpos]
    emb_u = jnp.where(plan.ok[:, None], back_u, 0)

    shard = shard._replace(
        counters=shard.counters.at[st.ROUTE_DROPS].add(plan.n_drop)
    )
    return shard, emb_u, RaggedCtx(
        plan=plan, lctx=lctx, inverse=runiq.inverse,
        miss_hi=runiq.hi, miss_lo=runiq.lo, miss=runiq.valid & ~found,
        owner_sorted=owner_sorted,
    )


def exchange_apply_grads(
    spec: TableSpec, shard: TableShard, ctx: RaggedCtx, g_u, axis: str,
    rcap: int, g2_mean=None,
) -> TableShard:
    """Gradient return over the SAME plan: per-unique grads ride the forward
    geometry to their owners, segment-sum per key, one in-place update."""
    from meepoembedding_tpu.parallel import sharded_table as st

    plan = ctx.plan
    # same wire-dtype policy (and parity caveat) as the dense exchange
    wire_dtype = (
        spec.dtype
        if spec.dtype == jnp.bfloat16 and st.GRAD_WIRE_BF16
        else jnp.float32
    )
    g_w = g_u.astype(wire_dtype)
    g_sorted = g_w if ctx.owner_sorted else g_w[plan.order]  # [U, dim]
    recv_g = jnp.zeros((rcap, spec.dim), wire_dtype)
    recv_g = _transport(
        g_sorted, recv_g, plan.in_off, plan.send, plan.out_off, plan.recv, axis
    ).astype(jnp.float32)

    if spec.dim <= 128 and not isinstance(ctx.lctx, jax.Array):
        lctx = ctx.lctx
        g_win = xla_ops.grads_to_window(
            spec, recv_g, lctx.sub, ctx.inverse, lctx.slot.shape[0]
        )
        return optim.apply_sparse_grads_ctx(spec, shard, lctx, g_win, g2_mean=g2_mean)
    slot = ctx.lctx
    g_per_key = dedup.segment_sum_grads(recv_g, ctx.inverse, num_unique=slot.shape[0])
    return optim.apply_sparse_grads(spec, shard, slot, g_per_key)
