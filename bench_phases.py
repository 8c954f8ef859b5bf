"""Phase attribution for the headline hot path at the REAL bench config.

Times jitted prefixes of the train cycle (dedup -> +lookup_train -> +forward
transform -> +grad-to-window -> +update) with bench.py's depth-capped
pipelined windows, so deltas attribute cost per phase. Also isolates the
rowwise accumulator (sgd-delta variant on the same shard).

Run AFTER bench.py-style prefill; shares its env knobs.
"""

import os
import sys
import time
from functools import partial

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from meepoembedding_tpu.device import bench_device

    bench_device()
    import jax
    import jax.numpy as jnp

    from meepoembedding_tpu.config import OptimizerConfig, TableConfig
    from meepoembedding_tpu.ops import dedup, optim
    from meepoembedding_tpu.table import hashing, xla_ops
    from meepoembedding_tpu.table.layout import TableSpec, alloc_shard

    cap = int(os.environ.get("MEEPO_BENCH_CAP", 1 << 25))
    batch = int(os.environ.get("MEEPO_BENCH_BATCH", 1 << 19))
    dim = int(os.environ.get("MEEPO_BENCH_DIM", 32))
    steps = int(os.environ.get("MEEPO_BENCH_STEPS", 20))
    # min-of-W windows: host stalls can only inflate a window
    nwin = int(os.environ.get("MEEPO_BENCH_WINDOWS", 3))
    dtype = os.environ.get("MEEPO_BENCH_DTYPE", "float32")
    # f32 at 2^27 cannot fit HBM; match bench.py's config-2 fill
    fill = float(os.environ.get("MEEPO_BENCH_FILL",
                                0.75 if cap >= (1 << 27) else 0.8))
    d = int(os.environ.get("MEEPO_BENCH_DEPTH", 2))

    cfg = TableConfig(
        dim=dim, capacity=cap, value_dtype=dtype,
        optimizer=OptimizerConfig(kind="rowwise_adagrad", learning_rate=0.05),
        initializer_scale=0.01,
        max_probe_rounds=2,
        insert_cap=1 << 15,
    )
    spec = TableSpec.from_config(cfg, num_shards=1)
    import dataclasses as _dc
    spec_prefill = _dc.replace(spec, insert_cap=None)
    log(f"cap={cap} batch={batch} dim={dim}")

    shard = jax.jit(lambda: alloc_shard(spec))()
    jax.block_until_ready(shard.values)
    n_live = int(spec.capacity * fill)
    key_mult = np.int64(0x9E3779B97F4A7C15 & 0x7FFFFFFFFFFFFFFF)

    @partial(jax.jit, donate_argnums=(0,))
    def prefill_step(shard, hi, lo, step):
        valid = hashing.is_valid(hi, lo)
        shard, ctx = xla_ops.lookup_train(spec_prefill, shard, hi, lo, valid, step)
        shard = optim.apply_sparse_grads_ctx(
            spec_prefill, shard, ctx, jnp.zeros_like(ctx.g128))
        return shard

    pb = min(batch, 1 << 20)
    t0 = time.perf_counter()
    for i in range(0, n_live, pb):
        n = min(pb, n_live - i)
        ids = (np.arange(i, i + n, dtype=np.int64)) * key_mult
        if n < pb:
            ids = np.concatenate([ids, np.full(pb - n, hashing.EMPTY_ID)])
        hi, lo = hashing.split_ids(ids)
        shard = prefill_step(shard, jnp.asarray(hi), jnp.asarray(lo), jnp.int32(0))
        if (i // pb) % 4 == 3:
            jax.block_until_ready(shard.counters)
    jax.block_until_ready(shard.values)
    log(f"prefill {n_live} in {time.perf_counter()-t0:.1f}s")

    rng = np.random.default_rng(0)
    zipf_s = 1.05

    def stream_batch():
        t = 1.0 - zipf_s
        u = rng.random(batch)
        k = ((float(n_live) ** t - 1.0) * u + 1.0) ** (1.0 / t)
        k = np.minimum(k.astype(np.int64), n_live) - 1
        return k * key_mult

    ucap = int(os.environ.get("MEEPO_BENCH_UCAP", max(1024, batch // 2)))
    gseed = jnp.float32(1e-4)

    batches = [hashing.split_ids(stream_batch()) for _ in range(steps)]
    batches = [(jax.device_put(jnp.asarray(h)), jax.device_put(jnp.asarray(l)))
               for h, l in batches]
    jax.block_until_ready(batches)

    def timed(name, fn, donate_shard):
        """fn(shard, hi, lo, step) -> (shard, scalar). Windowed, depth-capped."""
        nonlocal shard
        sh, acc = fn(shard, *batches[0], jnp.int32(1))
        jax.block_until_ready(acc)
        if donate_shard:
            shard = sh
        windows = []
        for _w in range(nwin):
            t0 = time.perf_counter()
            accs = []
            for i, (h, l) in enumerate(batches):
                sh, acc = fn(shard, h, l, jnp.int32(2 + i))
                if donate_shard:
                    shard = sh
                accs.append(acc)
                if i >= d:
                    jax.block_until_ready(accs[i - d])
            jax.block_until_ready((shard, accs[-1]))
            windows.append((time.perf_counter() - t0) / steps)
        dt = min(windows) * 1e3
        ws = ",".join(f"{w*1e3:.0f}" for w in windows)
        log(f"{name:40s} {dt:8.2f} ms   [{ws}]")
        return dt

    # --- variants ------------------------------------------------------------
    @partial(jax.jit, donate_argnums=(0,))
    def v_dedup(shard, hi, lo, step):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        return shard, uniq.count

    @partial(jax.jit, donate_argnums=(0,))
    def v_lookup(shard, hi, lo, step):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        shard, ctx = xla_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, step)
        return shard, jnp.sum(ctx.slot)

    @partial(jax.jit, donate_argnums=(0,))
    def v_fwd(shard, hi, lo, step):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        shard, ctx = xla_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, step)
        out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
        return shard, jnp.sum(out)

    @partial(jax.jit, donate_argnums=(0,))
    def v_g2w(shard, hi, lo, step):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        shard, ctx = xla_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, step)
        out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
        g = out * 1e-3 + gseed
        g_u = xla_ops.grads_to_window(spec, g, ctx.sub, uniq.inverse, ucap)
        return shard, jnp.sum(g_u)

    def full_cycle(shard, hi, lo, step):
        uniq = dedup.unique_pairs(hi, lo, ucap)
        shard, ctx = xla_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, step)
        out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
        g = out * 1e-3 + gseed
        g_u = xla_ops.grads_to_window(spec, g, ctx.sub, uniq.inverse, ucap)
        shard = optim.apply_sparse_grads_ctx(spec, shard, ctx, g_u)
        return shard, jnp.sum(out)

    v_full = partial(jax.jit, donate_argnums=(0,))(full_cycle)

    @partial(jax.jit, donate_argnums=(0,))
    def v_sgdlike(shard, hi, lo, step):
        # identical to full but skips the accumulator plane traffic: the
        # values delta uses a fixed scale (accum cost = v_full - this)
        uniq = dedup.unique_pairs(hi, lo, ucap)
        shard, ctx = xla_ops.lookup_train(spec, shard, uniq.hi, uniq.lo, uniq.valid, step)
        out = xla_ops.rows_for_batch(spec, ctx.g128, ctx.sub, uniq.inverse)
        g = out * 1e-3 + gseed
        gwin = xla_ops.grads_to_window(spec, g, ctx.sub, uniq.inverse, ucap)
        slot, fresh = ctx.slot, ctx.fresh
        enabled = slot >= 0
        gwin = jnp.where(enabled[:, None], gwin, 0).astype(jnp.float32)
        vrow = jnp.where(enabled, jnp.clip(slot, 0) // spec.pack, shard.values.shape[0])
        init_add = jnp.where(fresh[:, None], ctx.g128.astype(jnp.float32), 0.0)
        delta = init_add - 0.05 * gwin
        values = xla_ops.values_scatter_add(shard.values, vrow, delta)
        return shard._replace(values=values), jnp.sum(out)

    timed("dedup only", v_dedup, True)
    timed("+ lookup_train (probe/plan/gather)", v_lookup, True)
    timed("+ rows_for_batch (fwd out)", v_fwd, True)
    timed("+ grads_to_window", v_g2w, True)
    timed("FULL (rowwise adagrad)", v_full, True)
    timed("FULL minus accum (sgd-like)", v_sgdlike, True)

    @partial(jax.jit, donate_argnums=(0,))
    def v_static(values, slot, _lo, step):
        rows = xla_ops.gather_values(spec, values, slot)
        g = rows * 1e-3 + gseed
        values = xla_ops.scatter_add_values(spec, values, slot, -0.05 * g,
                                            jnp.ones(slot.shape, bool))
        return values, jnp.sum(rows)

    # static denominators on the same allocation
    slots_np = rng.integers(0, n_live, size=(steps, batch))
    slots = [jax.device_put(jnp.asarray(s, jnp.int32)) for s in slots_np]
    jax.block_until_ready(slots)
    values = shard.values

    def timed_static(name, fn):
        nonlocal values
        v, a = fn(values, slots[0], None, jnp.int32(0))
        jax.block_until_ready(a)
        values = v
        windows = []
        for _w in range(nwin):
            t0 = time.perf_counter()
            accs = []
            for i, s in enumerate(slots):
                values_new, acc = fn(values, s, None, jnp.int32(i))
                values = values_new
                accs.append(acc)
                if i >= d:
                    jax.block_until_ready(accs[i - d])
            jax.block_until_ready((values, accs[-1]))
            windows.append((time.perf_counter() - t0) / steps)
        ws = ",".join(f"{w*1e3:.0f}" for w in windows)
        log(f"{name:40s} {min(windows)*1e3:8.2f} ms   [{ws}]")

    timed_static("STATIC (xla scatter)", v_static)


if __name__ == "__main__":
    main()
