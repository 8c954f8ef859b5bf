"""Sparse in-place optimizers for dynamic tables (SURVEY.md C4) and a minimal
dense optimizer for the tower.

The reference class applies rowwise-AdaGrad/Adam to touched rows with CUDA
scatter kernels, bypassing the framework's dense optimizer (README.md:2
"high-performance"). Here each update is a gather of the touched rows'
state, a vectorized math block, and row-granular scatter-adds back into the
donated table arrays — XLA performs them in place.

Grads arrive already deduped/segment-summed: one grad row per unique slot,
so every touched slot appears at most once (no duplicate-update hazard).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from meepoembedding_tpu.config import OptimizerConfig
from meepoembedding_tpu.table.layout import TableShard, TableSpec
from meepoembedding_tpu.table.xla_ops import (
    _expand_row_update,
    gather_bucket_plane,
    gather_values,
    scatter_add_bucket_plane,
    scatter_add_values,
    scatter_bucket_plane,
    values_scatter_add,
)


def row_apply_delta(spec: TableSpec, plane, slot, delta, enabled):
    """plane[rows of slot] += delta as ONE duplicate-tolerant row scatter-add:
    each slot's delta expands to its 128-lane window (zeros elsewhere) and
    lands with `.at[vrow].add`. Packed slots may share a storage row, but
    since slots are unique each ELEMENT receives at most one nonzero
    contribution — the update is exact."""
    vrow, rowupd = _expand_row_update(spec, slot, delta.astype(jnp.float32))
    if spec.dim <= 128:
        en = enabled
    else:
        en = jnp.repeat(enabled, spec.rows_per_slot)
    return values_scatter_add(plane, jnp.where(en, vrow, plane.shape[0]), rowupd)


def apply_sparse_grads_ctx(
    spec: TableSpec, shard: TableShard, ctx, gwin: jax.Array, g2_mean=None
) -> TableShard:
    """Fused update for the `xla_ops.lookup_train` hot path: the values plane
    receives fresh-row INIT + optimizer delta in ONE scatter pass into the
    donated plane, and fresh rows' accumulator init rides the accum scatter.
    Window-space [U, 128] grads; rowwise/sgd only (the production hot loop);
    other optimizer kinds take a two-pass fallback.

    `g2_mean` maps the raw per-row sum of squared grads to the accumulator
    increment (default: / spec.dim). A column-sharded table
    (parallel/colsharded.py) passes `lambda s: psum(s, 'c') / global_dim` so
    the ROWWISE accumulator keeps full-row semantics across column shards
    (full-dim adagrad/adam are per-lane and need no cross-column coupling)."""
    opt = spec.optimizer
    slot, fresh = ctx.slot, ctx.fresh
    enabled = slot >= 0
    gwin = jnp.where(enabled[:, None], gwin, 0).astype(jnp.float32)
    vrow = jnp.where(enabled, jnp.clip(slot, 0) // spec.pack, shard.values.shape[0])
    init_add = jnp.where(fresh[:, None], ctx.g128.astype(jnp.float32), 0.0)
    if opt.kind == "sgd":
        with jax.named_scope("meepo.values_update"):
            delta = init_add - opt.learning_rate * gwin
            values = values_scatter_add(shard.values, vrow, delta)
        return shard._replace(values=values)
    if opt.kind == "rowwise_adagrad":
        (accum_plane,) = shard.opt_rowwise
        with jax.named_scope("meepo.accum_update"):
            a_old = gather_bucket_plane(accum_plane, slot)  # fresh slots -> 0
            g2 = jnp.sum(gwin * gwin, axis=1)
            g2 = g2 / spec.dim if g2_mean is None else g2_mean(g2)
            acc_add = g2 + jnp.where(fresh, jnp.float32(opt.initial_accumulator), 0.0)
            a_new = a_old + acc_add
            accum_plane = scatter_add_bucket_plane(accum_plane, slot, acc_add, enabled)
        with jax.named_scope("meepo.values_update"):
            scale = opt.learning_rate * jax.lax.rsqrt(a_new + opt.eps)
            delta = init_add - scale[:, None] * gwin
            values = values_scatter_add(shard.values, vrow, delta)
        return shard._replace(values=values, opt_rowwise=(accum_plane,))
    # fallback (adagrad/adam): write fresh inits, then the generic path.
    # Fresh full-dim slots are zero by the alloc invariant; fresh rowwise
    # accumulators get their init here so the generic math sees it.
    from meepoembedding_tpu.table.xla_ops import scatter_add_values, window_extract

    # collapse the [U,128] window rows to [U,dim] before the row scatter —
    # scatter_add_values expects row-space updates (passing g128 directly
    # breaks the window-placement matmul for dim < 128)
    init_rows = window_extract(spec, ctx.g128, ctx.sub)
    values = scatter_add_values(spec, shard.values, slot, init_rows, fresh)
    shard = shard._replace(values=values)
    if shard.opt_rowwise:
        acc0 = jnp.full_like(ctx.sub, opt.initial_accumulator, jnp.float32)
        shard = shard._replace(
            opt_rowwise=(
                scatter_add_bucket_plane(shard.opt_rowwise[0], slot, acc0, fresh),
            )
            + shard.opt_rowwise[1:]
        )
    grad = window_extract(spec, gwin, ctx.sub)
    return apply_sparse_grads(spec, shard, slot, grad)


def apply_sparse_grads_window(
    spec: TableSpec, shard: TableShard, slot: jax.Array, gwin: jax.Array
) -> TableShard:
    """Window-space fast path (dim < 128): per-slot grads arrive as [U, 128]
    rows with each grad already in its slot's lane window (zeros elsewhere,
    see xla_ops.segment_sum_grads_window). Supported for the rowwise/sgd
    optimizers the production hot loop uses; other kinds collapse to [U, dim]
    and take the generic path."""
    opt = spec.optimizer
    enabled = slot >= 0
    gwin = jnp.where(enabled[:, None], gwin, 0).astype(jnp.float32)
    vrow = jnp.where(enabled, jnp.clip(slot, 0) // spec.pack, shard.values.shape[0])
    if opt.kind == "sgd":
        values = values_scatter_add(shard.values, vrow, -opt.learning_rate * gwin)
        return shard._replace(values=values)
    if opt.kind == "rowwise_adagrad":
        (accum_plane,) = shard.opt_rowwise
        a_old = gather_bucket_plane(accum_plane, slot)
        g2 = jnp.sum(gwin * gwin, axis=1) / spec.dim  # zeros outside window
        a_new = a_old + g2
        accum_plane = scatter_add_bucket_plane(accum_plane, slot, g2, enabled)
        scale = opt.learning_rate * jax.lax.rsqrt(a_new + opt.eps)
        values = values_scatter_add(shard.values, vrow, -scale[:, None] * gwin)
        return shard._replace(values=values, opt_rowwise=(accum_plane,))
    # generic fallback: collapse window rows to [U, dim]
    from meepoembedding_tpu.table.xla_ops import window_extract

    sub = jnp.clip(slot, 0) % spec.pack
    return apply_sparse_grads(spec, shard, slot, window_extract(spec, gwin, sub))


def apply_sparse_grads(
    spec: TableSpec, shard: TableShard, slot: jax.Array, grad: jax.Array
) -> TableShard:
    """Update table rows at `slot` with per-row grads [n, dim]. slot < 0
    (denied/dropped ids) is a no-op. Dispatches on spec.optimizer.kind."""
    opt = spec.optimizer
    enabled = slot >= 0
    grad = jnp.where(enabled[:, None], grad, 0).astype(jnp.float32)
    kind = opt.kind
    if kind == "sgd":
        delta = -opt.learning_rate * grad
        values = row_apply_delta(spec, shard.values, slot, delta, enabled)
        return shard._replace(values=values)

    if kind == "rowwise_adagrad":
        # One accumulator scalar per row: a += mean(g^2); w -= lr/sqrt(a) * g.
        # The accumulator update is expressed as an ADD (duplicate-tolerant
        # fast row scatter); a_old + g2 in place equals the a_new used for
        # the scale bit-exactly.
        (accum_plane,) = shard.opt_rowwise
        a_old = gather_bucket_plane(accum_plane, slot)
        g2 = jnp.mean(grad * grad, axis=1)
        a_new = a_old + g2
        accum_plane = scatter_add_bucket_plane(accum_plane, slot, g2, enabled)
        scale = opt.learning_rate * jax.lax.rsqrt(a_new + opt.eps)
        values = row_apply_delta(spec, shard.values, slot, -scale[:, None] * grad, enabled)
        return shard._replace(values=values, opt_rowwise=(accum_plane,))

    if kind == "adagrad":
        (accum_plane,) = shard.opt_fulldim
        a_old = gather_values(spec, accum_plane, slot).astype(jnp.float32)
        a_new = a_old + grad * grad
        accum_plane = row_apply_delta(spec, accum_plane, slot, a_new - a_old, enabled)
        delta = -opt.learning_rate * grad * jax.lax.rsqrt(a_new + opt.eps)
        values = row_apply_delta(spec, shard.values, slot, delta, enabled)
        return shard._replace(values=values, opt_fulldim=(accum_plane,))

    if kind == "adam":
        # Sparse Adam without bias correction by global step (lazy variant:
        # moments update only on touched rows, the standard trade-off for
        # dynamic tables).
        m_plane, v_plane = shard.opt_fulldim
        m_old = gather_values(spec, m_plane, slot).astype(jnp.float32)
        v_old = gather_values(spec, v_plane, slot).astype(jnp.float32)
        m_new = opt.beta1 * m_old + (1 - opt.beta1) * grad
        v_new = opt.beta2 * v_old + (1 - opt.beta2) * grad * grad
        m_plane = row_apply_delta(spec, m_plane, slot, m_new - m_old, enabled)
        v_plane = row_apply_delta(spec, v_plane, slot, v_new - v_old, enabled)
        delta = -opt.learning_rate * m_new * jax.lax.rsqrt(v_new + opt.eps * opt.eps)
        values = row_apply_delta(spec, shard.values, slot, delta, enabled)
        return shard._replace(values=values, opt_fulldim=(m_plane, v_plane))

    if kind == "momentum":
        # Polyak momentum, lazy (moment updates only on touched rows)
        (m_plane,) = shard.opt_fulldim
        m_old = gather_values(spec, m_plane, slot).astype(jnp.float32)
        m_new = opt.beta1 * m_old + grad
        m_plane = row_apply_delta(spec, m_plane, slot, m_new - m_old, enabled)
        values = row_apply_delta(
            spec, shard.values, slot, -opt.learning_rate * m_new, enabled
        )
        return shard._replace(values=values, opt_fulldim=(m_plane,))

    if kind == "ftrl":
        # FTRL-Proximal (McMahan et al., "Ad Click Prediction: a View from
        # the Trenches"), the classic sparse CTR optimizer. The weight is a
        # CLOSED FORM of (z, n) — w = prox(z, n) — so the values plane is
        # updated by the exact delta w_new - w_old (stays in the fast
        # ADD-form row scatter; evict's subtract-to-zero invariant holds).
        z_plane, n_plane = shard.opt_fulldim
        z_old = gather_values(spec, z_plane, slot).astype(jnp.float32)
        n_old = gather_values(spec, n_plane, slot).astype(jnp.float32)
        w_old = gather_values(spec, shard.values, slot).astype(jnp.float32)
        alpha = opt.learning_rate
        n_new = n_old + grad * grad
        sigma = (jnp.sqrt(n_new) - jnp.sqrt(n_old)) / alpha
        z_new = z_old + grad - sigma * w_old
        denom = (opt.ftrl_beta + jnp.sqrt(n_new)) / alpha + opt.l2
        w_new = jnp.where(
            jnp.abs(z_new) > opt.l1,
            (jnp.sign(z_new) * opt.l1 - z_new) / denom,
            0.0,
        )
        z_plane = row_apply_delta(spec, z_plane, slot, z_new - z_old, enabled)
        n_plane = row_apply_delta(spec, n_plane, slot, n_new - n_old, enabled)
        values = row_apply_delta(spec, shard.values, slot, w_new - w_old, enabled)
        return shard._replace(values=values, opt_fulldim=(z_plane, n_plane))

    raise ValueError(f"unknown sparse optimizer: {kind}")


# --- dense tower optimizer (SGD/Adam over a pytree; optax-compatible shape) --

def dense_sgd_init(params):
    return ()


def dense_sgd_update(params, grads, state, lr: float):
    # cast back to the param dtype: bf16 towers must stay bf16 (math in f32)
    new = jax.tree.map(
        lambda p, g: (p.astype(jnp.float32) - lr * g).astype(p.dtype),
        params, grads,
    )
    return new, state


def dense_adam_init(params):
    # moments in f32 regardless of the tower dtype (bf16 moment decay at
    # b2=0.999 rounds to a no-op)
    z = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    return (
        z,
        jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
        jnp.zeros((), jnp.int32),
    )


def dense_adam_update(params, grads, state, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    m, v, t = state
    t = t + 1
    m = jax.tree.map(
        lambda m_, g: b1 * m_ + (1 - b1) * g.astype(jnp.float32), m, grads
    )
    v = jax.tree.map(
        lambda v_, g: b2 * v_ + (1 - b2) * jnp.square(g.astype(jnp.float32)),
        v, grads,
    )
    tf = t.astype(jnp.float32)
    c1 = 1.0 / (1.0 - b1**tf)
    c2 = 1.0 / (1.0 - b2**tf)
    new = jax.tree.map(
        lambda p, m_, v_: (
            p.astype(jnp.float32)
            - lr * (m_ * c1) * jax.lax.rsqrt(v_ * c2 + eps * eps)
        ).astype(p.dtype),
        params,
        m,
        v,
    )
    return new, (m, v, t)


def clip_by_global_norm(grads, max_norm: float):
    """Scale a dense-grad pytree so its GLOBAL L2 norm is <= max_norm (the
    standard stabilizer for deep towers; SURVEY.md C18). Norm accumulates in
    f32 regardless of tower dtype. max_norm == 0.0 zeroes the dense grads —
    a deliberate degenerate mode that freezes the towers (embedding-only
    fine-tune, e.g. adapting a warm-started table to new ids).

    In the sharded trainers this is applied AFTER the dense-grad psum, so
    the clip decision is identical on every device (no divergence)."""
    sq = sum(
        jnp.sum(jnp.square(g.astype(jnp.float32))) for g in jax.tree.leaves(grads)
    )
    norm = jnp.sqrt(sq)
    scale = jnp.minimum(1.0, max_norm / jnp.maximum(norm, 1e-30))
    return jax.tree.map(lambda g: (g.astype(jnp.float32) * scale).astype(g.dtype),
                        grads)


def schedule_lr(kind: str, base_lr: float, step, total_steps: int,
                warmup_steps: int = 0):
    """Dense-tower learning-rate schedule, evaluated INSIDE the jitted step
    from the traced step counter (no per-step recompiles; SURVEY.md C18).

    kind: "constant" | "linear" (decay to 0 over total_steps) |
    "cosine" (half-cosine to 0) | any with warmup_steps > 0 ramping
    linearly from 0 first. The sparse optimizers keep their own static rate
    (adaptive family; per-row accumulators already anneal it)."""
    if kind not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown lr schedule {kind!r}")
    t = jnp.asarray(step, jnp.float32)
    scale = jnp.float32(1.0)
    if warmup_steps > 0:
        scale = jnp.minimum(t / float(warmup_steps), 1.0)
        t = jnp.maximum(t - float(warmup_steps), 0.0)
    horizon = max(total_steps - warmup_steps, 1)
    frac = jnp.clip(t / float(horizon), 0.0, 1.0)
    if kind == "linear":
        scale = scale * (1.0 - frac)
    elif kind == "cosine":
        scale = scale * 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
    return jnp.float32(base_lr) * scale
