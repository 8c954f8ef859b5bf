"""Stage-level timing of the dynamic-table hot path on the current device
(SURVEY.md C20 auxiliary): isolates dedup / probe / insert-plan / gather /
segment-sum / optimizer-update so regressions are attributable.

Env: MEEPO_BENCH_CAP (default 2^22), MEEPO_BENCH_BATCH (default 2^19)."""

import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(name, fn, *args, steps=10):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / steps * 1e3
    log(f"{name:34s} {dt:9.3f} ms")
    return dt


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.config import OptimizerConfig, TableConfig
    from meepoembedding_tpu.ops import dedup, optim
    from meepoembedding_tpu.table import hashing, xla_ops
    from meepoembedding_tpu.table.layout import TableSpec, alloc_shard

    cap = int(os.environ.get("MEEPO_BENCH_CAP", 1 << 22))
    batch = int(os.environ.get("MEEPO_BENCH_BATCH", 1 << 19))
    dim = int(os.environ.get("MEEPO_BENCH_DIM", 32))
    cfg = TableConfig(
        dim=dim, capacity=cap,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
    )
    spec = TableSpec.from_config(cfg)
    log(f"cap={cap} batch={batch} dim={dim}")

    shard = jax.jit(lambda: alloc_shard(spec))()
    n_live = int(cap * 0.8)
    key_mult = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)

    @jax.jit
    def prefill(shard, hi, lo):
        valid = hashing.is_valid(hi, lo)
        shard, _, _ = xla_ops.find_or_insert(spec, shard, hi, lo, valid, jnp.int32(0))
        return shard

    pf = min(batch, 1 << 19)
    for i in range(0, n_live, pf):
        ids = np.arange(i, i + pf, dtype=np.int64) * key_mult
        hi, lo = hashing.split_ids(ids)
        shard = prefill(shard, jnp.asarray(hi), jnp.asarray(lo))
    jax.block_until_ready(shard.values)
    log(f"prefilled {n_live}")

    rng = np.random.default_rng(0)
    ids = rng.integers(0, n_live, size=batch) * key_mult
    hi, lo = (jnp.asarray(x) for x in hashing.split_ids(ids))

    # --- stages ---------------------------------------------------------------
    uniq = jax.jit(lambda h, l: dedup.unique_pairs(h, l, h.shape[0]))(hi, lo)
    jax.block_until_ready(uniq)
    timeit("dedup.unique_pairs", jax.jit(lambda h, l: dedup.unique_pairs(h, l, h.shape[0])), hi, lo)

    probe_fn = jax.jit(lambda s, u: xla_ops.probe(spec, s, u.hi, u.lo, u.valid))
    pr = probe_fn(shard, uniq)
    timeit("probe (all-hit)", probe_fn, shard, uniq)

    slot = jnp.where(pr.found, pr.slot, -1)

    fi_fn = jax.jit(
        lambda s, u: xla_ops.find_or_insert(spec, s, u.hi, u.lo, u.valid, jnp.int32(1))[0].counters
    )
    timeit("find_or_insert (all-hit)", fi_fn, shard, uniq)

    gather_fn = jax.jit(lambda s, sl: xla_ops.lookup_rows(spec, s, sl))
    rows = gather_fn(shard, slot)
    timeit("lookup_rows (gather)", gather_fn, shard, slot)

    inv_fn = jax.jit(lambda r, u: r[u.inverse])
    timeit("inverse gather [n,dim]", inv_fn, rows, uniq)

    g = rows * 1e-3
    seg_fn = jax.jit(lambda g, u: dedup.segment_sum_grads(g, u.inverse, u.hi.shape[0]))
    gu = seg_fn(g, uniq)
    timeit("segment_sum_grads", seg_fn, g, uniq)

    upd_fn = jax.jit(lambda s, sl, gu: optim.apply_sparse_grads(spec, s, sl, gu).counters)
    timeit("apply_sparse_grads (adagrad)", upd_fn, shard, slot, gu)

    # sub-stages of the update
    from meepoembedding_tpu.table.xla_ops import gather_bucket_plane, scatter_bucket_plane
    from meepoembedding_tpu.ops.optim import row_apply_delta

    gbp = jax.jit(lambda s, sl: gather_bucket_plane(s.opt_rowwise[0], sl))
    timeit("  gather_bucket_plane (accum)", gbp, shard, slot)
    a = gbp(shard, slot)
    sbp = jax.jit(lambda s, sl, a: scatter_bucket_plane(s.opt_rowwise[0], sl, a, sl >= 0))
    timeit("  scatter_bucket_plane (accum)", sbp, shard, slot, a)
    rad = jax.jit(lambda s, sl, gu: row_apply_delta(spec, s.values, sl, gu, sl >= 0))
    timeit("  row_apply_delta (values)", rad, shard, slot, gu)

    # raw combine cost: exact byte-plane vs plain float cumsum
    from meepoembedding_tpu.ops.dedup import combine_rows_by_vrow
    from meepoembedding_tpu.ops.dedup import sorted_run_sums

    vrow = jnp.clip(slot, 0) // spec.pack
    rowupd = jnp.zeros((batch, 128), jnp.float32) + 0.5
    cmb = jax.jit(lambda v, r, e: combine_rows_by_vrow(v, r, e))
    timeit("  combine_rows_by_vrow (exact)", cmb, vrow, rowupd, slot >= 0)

    srt = jax.jit(lambda v, r: sorted_run_sums(jnp.sort(v), r))
    timeit("  sorted_run_sums (float,+sort)", srt, vrow, rowupd)
    srx = jax.jit(lambda v, r: sorted_run_sums(jnp.sort(v), r, disjoint=True))
    timeit("  sorted_run_sums (exact,+sort)", srx, vrow, rowupd)

    cs1 = jax.jit(lambda r: jnp.cumsum(r, axis=0))
    timeit("  cumsum [n,128] f32", cs1, rowupd)
    arg = jax.jit(lambda v: jnp.argsort(v))
    timeit("  argsort [n] i32", arg, vrow)


if __name__ == "__main__":
    main()
